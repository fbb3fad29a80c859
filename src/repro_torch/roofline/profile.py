"""Collective profiler (port of ``repro.roofline.profile``): walk a
cell's one-group probe over the production mesh and rank its collectives
by per-device bytes (what a step's bottleneck collective is, with no
card).

    PYTHONPATH=src python -m repro_torch.roofline.profile --arch gemma3-27b \
        --shape train_4k [--variant ...] [--groups 1] [--top 15]

:func:`top_collectives` reads a collective log
(``parallel/collectives.recording``) where the reference reads the
collectives of a compiled HLO module, and returns the reference's shapes:
the largest individual collectives and the bytes aggregated by (kind,
origin). :func:`main` walks ``launch/dryrun.shrink_to_groups(cfg,
groups)`` with the dry run's ``lower_*`` (meta tensors, nothing launched)
and prints the reference's two tables.
"""
from __future__ import annotations

import argparse
import collections


def top_collectives(log, top: int = 15):
    """(rows, agg): ``rows`` the ``top`` largest collectives as (bytes,
    kind, axes, origin), largest first; ``agg`` the ``top`` largest
    ((kind, origin), bytes) sums over the whole log."""
    rows = sorted(((r.nbytes, r.kind, str(r.axes), r.origin)
                   for r in log), reverse=True)
    agg = collections.Counter()
    for b, kind, _, origin in rows:
        agg[(kind, origin)] += b
    return rows[:top], agg.most_common(top)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="")
    ap.add_argument("--groups", type=int, default=1)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.configs import shapes as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_production_mesh

    cfg = configs.get_config(args.arch)
    if args.variant:
        cfg = DR.VARIANTS[args.variant](cfg)
    cfg = DR.shrink_to_groups(cfg, args.groups)
    shape = SH.SHAPES[args.shape]
    mesh = make_production_mesh()
    if shape.kind == "train":
        walked, extra = DR.lower_train(cfg, shape, mesh, True)
    elif shape.kind == "prefill":
        walked, extra = DR.lower_prefill(cfg, shape, mesh, True)
    else:
        walked, extra = DR.lower_decode(cfg, shape, mesh, True)
    rows, agg = top_collectives(walked.log, args.top)
    print(f"# {args.arch} {args.shape} variant={args.variant or 'baseline'} "
          f"groups={args.groups} (cost_scale={extra.get('cost_scale', 1)})")
    print("## top individual collectives (per-device bytes)")
    for b, op, shp, name in rows:
        print(f"{b/2**20:9.1f} MiB  {op:18s} {shp:44s} {name}")
    print("## aggregated by (op, origin)")
    for (op, name), b in agg:
        print(f"{b/2**20:9.1f} MiB  {op:18s} {name}")


if __name__ == "__main__":
    main()
