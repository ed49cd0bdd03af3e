"""Per-frame communication accounting + multi-host scaling projection.

Scaling efficiency at several devices and hosts needs quantification even
without the hardware at hand. This module gives every sharded path an
**analytic per-frame communication budget** — the exact payload bytes of each
collective the compiled program issues — and a **roofline projection** of
multi-device/multi-host efficiency with stated, checkable bandwidths.

The byte counts are not estimates: ``hlo_collective_bytes`` parses the
compiled HLO of the actual sharded programs and tests assert the analytic
model matches the compiler op-for-op (tests/test_comm_model.py). The
*projection* is a model with three inputs you can check against any
deployment:

* the device-to-device link rate, looked up by ``device_kind`` in
  :data:`LINK_GBPS` (a device kind not in the table is an error);
* ``host_gbps`` — one-way bandwidth between hosts, which the caller states
  whenever the projection spans more than one host;
* ``compute_ms`` — a measured single-device frame time, scaled by 1/n under
  row sharding (the sharded paths do the same per-pixel work; seam tests
  prove identical outputs).

Projection structure: row-sharded paths exchange fixed-size halos between
*neighbor* shards — those transfers ride parallel links and do not grow with
n — while SGM's exact carry relay is a serial (n−1)-hop chain, and BA's
reductions are ring all-reduces whose wire time approaches 2·payload/bw.
Efficiency = T_comp/n ÷ (T_comp/n + T_comm_critical). Boundaries that cross
hosts pay the host link instead of the device link; with contiguous row
blocks per host there are exactly (hosts−1) such boundaries.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

from stepth.config import MatchConfig, PyramidConfig
from stepth.parallel.sharded import _refine_tiling, required_halo

# One-way device-to-device bandwidth (GB/s) by ``jax.Device.device_kind``.
# H100 SXM: NVLink 4, 900 GB/s total to the other GPUs of the host, 450 GB/s
# each way (NVIDIA H100 data sheet).
LINK_GBPS = {
    "NVIDIA H100 80GB HBM3": 450.0,
}


def link_gbps(device_kind: str) -> float:
    """Device-link bandwidth for ``device_kind``; no rate is assumed for a
    device that is not in :data:`LINK_GBPS`."""
    try:
        return LINK_GBPS[device_kind]
    except KeyError:
        raise ValueError(
            f"no link bandwidth known for device kind {device_kind!r}; "
            f"add it to LINK_GBPS with its source"
        ) from None


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective op in the per-device program.

    ``payload_bytes`` is the op's operand payload (what HLO shows);
    ``count`` its executions per frame/solve; ``serial_hops`` > 0 marks a
    shard-to-shard relay chain that occupies the critical path sequentially
    (count already includes the hops)."""

    kind: str  # "permute" | "allreduce"
    label: str
    payload_bytes: int
    count: int
    serial_hops: int = 0


@dataclasses.dataclass(frozen=True)
class CommReport:
    name: str
    collectives: Tuple[Collective, ...]
    # Device count the report was built for. Relay-chain collective counts are
    # proportional to (n−1) and halo/tile sizing is baked in at build time, so
    # ``project()`` rescales relay hops when projecting a different n and the
    # builders record n here to make that possible. ``None`` = n-independent
    # (e.g. BA all-reduces, whose ring factor project() derives itself).
    n: Optional[int] = None

    def op_bytes(self, kind: Optional[str] = None) -> int:
        """Σ payload·count — the number the HLO validation checks."""
        return sum(
            c.payload_bytes * c.count
            for c in self.collectives
            if kind is None or c.kind == kind
        )

    def op_counts(self, kind: Optional[str] = None, serial: Optional[bool] = None) -> int:
        """Σ count — executions per frame/solve. ``serial`` filters to relay
        chains (True) or parallel neighbor exchanges (False); these counts are
        the time model's critical-path inputs (a relay pays every hop
        sequentially, halos pay one payload regardless of n), validated
        op-for-op against compiled HLO in tests/test_comm_model.py."""
        return sum(
            c.count
            for c in self.collectives
            if (kind is None or c.kind == kind)
            and (serial is None or bool(c.serial_hops) == serial)
        )

    def table(self) -> str:
        rows = [
            f"  {c.kind:9s} {c.label:44s} {c.payload_bytes/1e3:10.1f} kB × {c.count}"
            for c in self.collectives
        ]
        total = self.op_bytes() / 1e6
        return "\n".join(rows + [f"  total collective payload: {total:.3f} MB"])


def _round_up(x, m):
    return (x + m - 1) // m * m


def comm_dense_sharded(cfg: MatchConfig, H: int, W: int, n: int) -> CommReport:
    """Collectives of :func:`parallel.sharded.match_pair_sharded`."""
    halo = required_halo(cfg)
    b = 4 * halo * W
    return CommReport(
        "match_pair_sharded",
        (
            Collective("permute", f"image halos 2 arrays × 2 dirs [{halo},{W}]",
                       b, 4),
            Collective("permute", f"median disparity halo [1,{W}]", 4 * W, 2),
        ),
        n=n,
    )


def comm_hierarchical_sharded(
    cfg: MatchConfig,
    pyr: PyramidConfig,
    H: int,
    W: int,
    n: int,
    tile_rows: int = 64,
    coarse_backend: str = "wta",
    coarse_sgm_directions: int = 4,
) -> CommReport:
    """Collectives of :func:`parallel.sharded.match_hierarchical_sharded`."""
    _, halo = _refine_tiling(H // n, pyr.levels, tile_rows, cfg.window, strict=False)
    cols = []
    lc = pyr.levels - 1
    W_c = W >> lc
    coarse_cfg = dataclasses.replace(cfg, num_disparities=pyr.coarsest_disparities)
    h_c = required_halo(coarse_cfg)
    if coarse_backend == "wta":  # the sharded dense tile: image + median halos
        cols.append(
            Collective(
                "permute", f"coarse l/r halos 2 × 2 dirs [{h_c},{W_c}]",
                4 * h_c * W_c, 4,
            )
        )
        cols.append(
            Collective("permute", f"coarse median halo [1,{W_c}]", 4 * W_c, 2)
        )
    else:  # sgm coarse: _sgm_tile halos + exact vertical carry relay + median
        h_sgm = h_c
        D_c = pyr.coarsest_disparities
        cols.append(
            Collective(
                "permute", f"sgm-coarse l/r halos 2 × 2 dirs [{h_sgm},{W_c}]",
                4 * h_sgm * W_c, 4,
            )
        )
        n_relay = 2 if coarse_sgm_directions >= 4 else 0
        n_relay += 4 if coarse_sgm_directions == 8 else 0
        if n_relay and n > 1:
            cols.append(
                Collective(
                    "permute",
                    f"sgm-coarse carry relay {n_relay} dirs × (n−1) [{W_c},{D_c}]",
                    4 * W_c * D_c, n_relay * (n - 1),
                    serial_hops=n_relay * (n - 1),
                )
            )
        cols.append(
            Collective("permute", f"sgm-coarse median halo [1,{W_c}]",
                       4 * W_c, 2)
        )
    for lvl in range(pyr.levels - 2, -1, -1):
        W_l = W >> lvl
        cols.append(
            Collective(
                "permute",
                f"refine L{lvl} l/r/prior halos 3 × 2 dirs [{halo},{W_l}]",
                4 * halo * W_l, 6,
            )
        )
    cols.append(
        Collective("permute", f"final median halo 2 dirs [{halo},{W}]",
                   4 * halo * W, 2)
    )
    return CommReport(f"match_hierarchical_sharded[{coarse_backend}]",
                      tuple(cols), n=n)


def comm_sgm_sharded(
    cfg: MatchConfig, H: int, W: int, n: int, directions: int = 4,
    exact: bool = True, warmup: int = 32,
) -> CommReport:
    """Collectives of :func:`parallel.sgm_sharded.match_pair_sgm_sharded`."""
    halo = required_halo(cfg)
    ext = halo + (0 if exact else warmup)
    D = cfg.num_disparities
    cols = [
        Collective("permute", f"l/r halos 2 × 2 dirs [{ext},{W}]",
                   4 * ext * W, 4),
        Collective("permute", f"median halo [1,{W}]", 4 * W, 2),
    ]
    if exact and n > 1:
        n_relay = (2 if directions >= 4 else 0) + (4 if directions == 8 else 0)
        if n_relay:
            cols.append(
                Collective(
                    "permute",
                    f"carry relay {n_relay} dirs × (n−1) hops [{W},{D}]",
                    4 * W * D, n_relay * (n - 1),
                    serial_hops=n_relay * (n - 1),
                )
            )
    return CommReport("match_pair_sgm_sharded", tuple(cols), n=n)


def comm_ba_sharded(
    C: int, Pn: int, lm_iters: int = 10, cg_iters: int = 10
) -> CommReport:
    """All-reduces of :func:`fusion.ba.solve_sharded` per solve call.

    Per LM iteration (fusion/ba.py::_schur_system/_schur_solve):
    cam_red [C,42] + pt_red [P,12] + Schur RHS [C,6]; S_apply (2 psums,
    [P,3]+[C,6]) runs once for r0 and once per CG iteration; back-substitute
    [P,3]; the accept test evaluates the cost twice (2 scalar psums each:
    Σr², Σw)."""
    per_lm = (
        (C * 42 + Pn * 12 + C * 6) * 4
        + (cg_iters + 1) * (Pn * 3 + C * 6) * 4
        + Pn * 3 * 4
        + 4 * 4
    )
    init_cost = 2 * 4  # cost_of at init
    return CommReport(
        "ba.solve_sharded",
        (
            Collective(
                "allreduce",
                f"per-LM reductions × {lm_iters} (C={C}, P={Pn}, cg={cg_iters})",
                per_lm, lm_iters,
            ),
            Collective("allreduce", "initial cost scalars", init_cost, 1),
        ),
    )


# ---------------------------------------------------------------------------
# HLO validation + roofline projection
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "f16": 2, "bf16": 2, "pred": 1,
                "f64": 8, "s64": 8, "u8": 1, "s8": 1, "u16": 2, "s16": 2}

_COLL_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s*"
    r"(collective-permute|all-reduce)(?:-start)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_txt: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_txt):
        if dt not in _DTYPE_BYTES:
            continue
        nelem = 1
        for d in dims.split(","):
            if d:
                nelem *= int(d)
        total += nelem * _DTYPE_BYTES[dt]
    return total


def hlo_collective_bytes(compiled_text: str):
    """Sum payload bytes of collective-permute / all-reduce ops in a compiled
    HLO module dump (``jitted.lower(...).compile().as_text()``). Returns
    ``{"permute": bytes, "allreduce": bytes}`` of *op payloads* (loop bodies
    counted once — use loop-free programs or multiply by trip counts)."""
    out = {"permute": 0, "allreduce": 0}
    for m in _COLL_RE.finditer(compiled_text):
        kind = "permute" if m.group(2) == "collective-permute" else "allreduce"
        out[kind] += _shape_bytes(m.group(1))
    return out


def hlo_collective_counts(compiled_text: str):
    """Number of collective-permute / all-reduce *ops* in a compiled HLO dump
    — the time model's critical-path input (relay chains unroll to one op per
    hop; parallel halo exchanges appear once per exchange regardless of n)."""
    out = {"permute": 0, "allreduce": 0}
    for m in _COLL_RE.finditer(compiled_text):
        kind = "permute" if m.group(2) == "collective-permute" else "allreduce"
        out[kind] += 1
    return out


@dataclasses.dataclass(frozen=True)
class Projection:
    n_devices: int
    n_hosts: int
    compute_ms: float  # per-device compute after 1/n scaling
    comm_ms: float  # critical-path communication
    efficiency: float  # vs perfect linear scaling


def project(
    report: CommReport,
    compute_ms_1chip: float,
    n_devices: int,
    device_kind: str,
    n_hosts: int = 1,
    host_gbps: Optional[float] = None,
) -> Projection:
    """Roofline efficiency projection for ``report`` on ``n_devices`` of
    ``device_kind`` spread over ``n_hosts`` (contiguous row blocks per host ⇒
    hosts−1 host-link boundaries; ``host_gbps`` is then required). Neighbor permutes ride parallel links (wall time = one
    payload per exchange, the slowest link class present); serial relays pay
    every hop; all-reduces pay the ring factor 2(n−1)/n on the slowest link
    class. No compute/comm overlap is assumed (conservative).

    Relay-chain counts in the report are proportional to (report.n − 1); when
    ``n_devices != report.n`` the per-round hop count is recovered from
    ``report.n`` and rescaled to (n_devices − 1), so projecting one report
    across a device grid is sound. Halo/tile sizing is still baked in at
    build time — for exact numbers rebuild the report per n (the builders
    take n; tools/scaling_model.py does this). A report built with n == 1
    cannot be projected to n > 1 (its relay collectives were elided) — that
    raises."""
    if report.n == 1 and n_devices > 1:
        raise ValueError(
            f"report {report.name!r} was built for n=1 (relay collectives "
            f"elided); rebuild it with n={n_devices} before projecting"
        )
    if n_hosts > 1 and host_gbps is None:
        raise ValueError("a projection over several hosts needs host_gbps")
    dev_bw = link_gbps(device_kind) * 1e9
    host_bw = (host_gbps or 0.0) * 1e9
    slow = host_bw if n_hosts > 1 else dev_bw
    comm_s = 0.0
    for c in report.collectives:
        if c.kind == "allreduce":
            wire = 2.0 * (n_devices - 1) / n_devices * c.payload_bytes
            comm_s += c.count * wire / slow
        elif c.serial_hops:
            # serial chain: per_round × (n−1) hops total, hosts−1 cross hosts
            built_n = report.n if report.n is not None else n_devices
            per_round = c.count // max(built_n - 1, 1)
            hops = per_round * max(n_devices - 1, 0)
            host_hops = 0
            if n_hosts > 1 and n_devices > 1:
                host_hops = per_round * (n_hosts - 1)
            comm_s += (hops - host_hops) * c.payload_bytes / dev_bw
            if host_hops:
                comm_s += host_hops * c.payload_bytes / host_bw
        else:
            # neighbor exchange: parallel across shard pairs; the host
            # boundary pair is the slow one when hosts > 1
            comm_s += c.count * c.payload_bytes / slow
    compute_ms = compute_ms_1chip / n_devices
    comm_ms = comm_s * 1e3
    eff = compute_ms / (compute_ms + comm_ms) if compute_ms > 0 else 0.0
    return Projection(n_devices, n_hosts, compute_ms, comm_ms, eff)
