"""Render the dry run's tables from its JSON (``launch/dryrun.py --out``)
and pick the three hillclimb candidates (worst roofline fraction, most
collective-bound, most representative of the paper's technique).

    PYTHONPATH=src python -m repro_torch.launch.report dryrun.json

The roofline fraction divides by the H100's data-sheet bf16 peak
(``launch/mesh.PEAK_FLOPS_BF16``); the record's keys are the reference's,
so either package's dry-run JSON renders."""

from __future__ import annotations

import json
import sys

from repro_torch.launch.mesh import PEAK_FLOPS_BF16


def fmt_bytes(b):
    return f"{b / 2**30:.2f}GiB"


def load(*paths):
    """Load and merge result files; later files override earlier records
    for the same (arch, shape, mesh) cell."""
    merged = {}
    for path in paths:
        with open(path) as f:
            for r in json.load(f):
                if r.get("opts"):
                    continue           # hillclimb variants stay separate
                merged[(r["arch"], r["shape"], r["mesh"])] = r
    return list(merged.values())


def roofline_rows(results):
    rows = []
    for r in results:
        if r.get("mesh") != "single" or r.get("status") != "ok":
            continue
        if "roofline" not in r:
            continue
        rf = r["roofline"]
        est = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        ideal = rf["model_flops_per_device"] / PEAK_FLOPS_BF16
        frac = ideal / est if est > 0 else 0.0
        rows.append({
            "arch": r["arch"], "shape": r["shape"],
            "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
            "collective_s": rf["collective_s"], "dominant": rf["dominant"],
            "useful": rf.get("useful_ratio"),
            "mem_gib": r["memory"]["total_nonalias_bytes"] / 2 ** 30,
            "fits": r["fits_hbm"], "frac": frac, "est_s": est,
            "ideal_s": ideal,
        })
    return rows


def render_table(rows):
    hdr = ("| arch | shape | compute (s) | memory (s) | collective (s) | "
           "dominant | useful ratio | HBM/chip | roofline frac |")
    sep = "|" + "---|" * 9
    out = [hdr, sep]
    for w in rows:
        u = f"{w['useful']:.2f}" if w["useful"] else "-"
        out.append(
            f"| {w['arch']} | {w['shape']} | {w['compute_s']:.3e} | "
            f"{w['memory_s']:.3e} | {w['collective_s']:.3e} | "
            f"{w['dominant']} | {u} | {w['mem_gib']:.2f}GiB"
            f"{'' if w['fits'] else ' (!)'} | {w['frac'] * 100:.1f}% |")
    return "\n".join(out)


def pick_hillclimb(rows):
    """worst roofline fraction among train cells, most collective-bound,
    most representative (train_4k of the largest dense arch)."""
    train = [r for r in rows if r["shape"] == "train_4k"]
    worst = min(rows, key=lambda r: r["frac"] if r["ideal_s"] > 1e-6 else 1)
    coll = max(rows, key=lambda r: (r["collective_s"]
                                    / max(r["est_s"], 1e-12)))
    rep = next((r for r in train if r["arch"] == "llama3-8b"), train[0])
    return {"worst": worst, "collective": coll, "representative": rep}


def dryrun_summary(results):
    lines = []
    n = {"ok": 0, "skipped": 0, "error": 0}
    for r in results:
        n[r["status"]] = n.get(r["status"], 0) + 1
        tag = f"{r['arch']} x {r['shape']} x {r['mesh']}"
        if r["status"] == "ok":
            mem = r["memory"]["total_nonalias_bytes"]
            lines.append(f"- {tag}: ok, {fmt_bytes(mem)}/chip, "
                         f"fits={r['fits_hbm']}, compile {r['compile_s']}s")
        elif r["status"] == "skipped":
            lines.append(f"- {tag}: SKIPPED ({r['reason'][:60]}...)")
        else:
            lines.append(f"- {tag}: ERROR {r['error'][:120]}")
    return n, lines


def resharded_lines(results):
    """The port's counter fallbacks (a record's ``resharded_ops``: ops
    DTensor refused on a sharded input, re-run by the dry run's counter
    on a replicated one): one line per cell that had any, after a header
    with the total; nothing for records without the key (the
    reference's)."""
    recs = [r for r in results if r.get("status") == "ok"
            and "resharded_ops" in r]
    if not recs:
        return []
    per = [(r, sum(n for st in r["resharded_ops"].values()
                   for n in st.values())) for r in recs]
    out = [f"\ncounter fallbacks (ops re-run on a replicated input): "
           f"{sum(n for _, n in per)} in {sum(n > 0 for _, n in per)} of "
           f"{len(per)} cells"]
    for r, n in per:
        if n:
            ops = ", ".join(f"{op} {st}" for op, st in
                            sorted(r["resharded_ops"].items()))
            out.append(f"  {r['arch']} x {r['shape']} x {r['mesh']}: "
                       f"{n} ({ops})")
    return out


def main():
    paths = sys.argv[1:] or ["dryrun_results.json"]
    results = load(*paths)
    n, lines = dryrun_summary(results)
    print(f"cells: {n}")
    rows = roofline_rows(results)
    print(render_table(rows))
    for line in resharded_lines(results):
        print(line)
    if not any(r["shape"] == "train_4k" for r in rows):
        return                  # the candidates need a train cell
    hc = pick_hillclimb(rows)
    print("\nhillclimb candidates:")
    for k, v in hc.items():
        print(f"  {k}: {v['arch']} x {v['shape']} "
              f"(frac {v['frac'] * 100:.1f}%, dom {v['dominant']})")


if __name__ == "__main__":
    main()
