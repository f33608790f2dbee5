"""Summarize a BENCH_LONGN artifact as a per-family crossover table.

    python tools/summarize_longn.py BENCH_LONGN.json

Prints, per (family, N): solves/s for each backend, the winner, and the
measured memory; flags infeasible (OOM) cells. Used to keep docs/MPC.md
honest about where the structured backends win.
"""
import json
import sys


def main(path):
    d = json.load(open(path))
    rows = d["rows"]
    fams = {}
    for r in rows:
        fams.setdefault(r["family"], {}).setdefault(
            r["N"], {})[r["backend"]] = r
    for fam in fams:
        print(f"\n{fam}")
        print(f"{'N':>5} {'dense':>12} {'banded':>12} {'scan':>12} "
              f"{'winner':>8}  peak MB (d/b/s)")
        for N in sorted(fams[fam]):
            cells = fams[fam][N]
            vals = {}
            mems = {}
            for be in ("dense", "banded", "scan"):
                c = cells.get(be)
                if c is None:
                    vals[be] = "-"
                    mems[be] = "-"
                elif c.get("infeasible"):
                    vals[be] = "OOM"
                    mems[be] = "OOM"
                elif "solves_per_s" not in c:
                    vals[be] = "ERR"
                    mems[be] = "?"
                else:
                    vals[be] = f"{c['solves_per_s']:.0f}"
                    pk = c.get("mem_peak_bytes", -1)
                    mems[be] = f"{pk/1e6:.0f}" if pk > 0 else "-"
            num = {be: float(v) for be, v in vals.items()
                   if v not in ("-", "OOM", "ERR")}
            win = max(num, key=num.get) if num else "-"
            print(f"{N:>5} {vals['dense']:>12} {vals['banded']:>12} "
                  f"{vals['scan']:>12} {win:>8}  "
                  f"{mems['dense']}/{mems['banded']}/{mems['scan']}")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
