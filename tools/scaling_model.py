"""Multi-device / multi-host scaling projections of the sharded paths.

Prints the roofline table: per-frame collective budgets (validated op-for-op
against compiled HLO in tests/test_comm_model.py) and a projected efficiency
at 2-32 devices from single-device times you measured, on the device link of
``--device-kind`` (stepth/parallel/comm_model.py LINK_GBPS).

    python tools/scaling_model.py --hier-ms T --hier-sgm-ms T --sgm-ms T \\
        --ba-ms-per-lm T [--device-kind "NVIDIA H100 80GB HBM3"] [--host-gbps B]

Rows over more than one host need ``--host-gbps``; without it only the
single-host rows are printed.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stepth.config import MatchConfig, PyramidConfig  # noqa: E402
from stepth.parallel import comm_model as cm  # noqa: E402


def show(build, compute_ms, configs, device_kind, host_gbps):
    """``build`` is a callable n → CommReport: the report is rebuilt for every
    grid point so (n−1)-proportional relay counts and n-dependent halo/tile
    sizing are exact at each n."""
    rep8 = build(8)
    print(f"\n=== {rep8.name} (single-device {compute_ms} ms/frame) ===")
    print(rep8.table())
    print(f"{'devices':>8} {'hosts':>6} {'compute':>9} {'comm':>8} {'eff':>6}")
    for n, hosts in configs:
        if hosts > 1 and host_gbps is None:
            continue
        p = cm.project(build(n), compute_ms, n, device_kind, hosts, host_gbps)
        print(f"{n:8d} {hosts:6d} {p.compute_ms:8.3f}ms {p.comm_ms:7.3f}ms "
              f"{p.efficiency*100:5.1f}%")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hier-ms", type=float, required=True,
                    help="1080p hierarchical frame time on one device")
    ap.add_argument("--hier-sgm-ms", type=float, required=True,
                    help="1080p hierarchical-sgm frame time on one device")
    ap.add_argument("--sgm-ms", type=float, required=True,
                    help="1080p full-resolution SGM (D=64, 4 dirs) frame time")
    ap.add_argument("--ba-ms-per-lm", type=float, required=True,
                    help="BA ms per LM iteration at 128 cams / 65,536 points")
    ap.add_argument("--device-kind", default="NVIDIA H100 80GB HBM3")
    ap.add_argument("--host-gbps", type=float, default=None,
                    help="one-way bandwidth between hosts, GB/s")
    a = ap.parse_args()
    grid = [(2, 1), (4, 1), (8, 1), (16, 2), (32, 4)]
    kw = dict(configs=grid, device_kind=a.device_kind, host_gbps=a.host_gbps)

    cfg = MatchConfig(num_disparities=128, window=9, cost="sad")
    pyr = PyramidConfig(levels=4, coarsest_disparities=16)
    show(lambda n: cm.comm_hierarchical_sharded(cfg, pyr, 1080, 1920, n),
         a.hier_ms, **kw)
    show(lambda n: cm.comm_hierarchical_sharded(cfg, pyr, 1080, 1920, n,
                                                coarse_backend="sgm"),
         a.hier_sgm_ms, **kw)

    scfg = MatchConfig(num_disparities=64, window=5, cost="sad", lr_threshold=1.0)
    for exact in (True, False):
        show(lambda n, e=exact: cm.comm_sgm_sharded(scfg, 1080, 1920, n,
                                                    directions=4, exact=e),
             a.sgm_ms, **kw)

    # BA: one solve call = 10 LM iters (all-reduce only — n-independent report)
    show(lambda n: cm.comm_ba_sharded(128, 65536, lm_iters=10, cg_iters=10),
         10 * a.ba_ms_per_lm, **kw)


if __name__ == "__main__":
    main()
