"""Evaluated-system presets (paper Table I), scaled to the allocation sizes
used in the paper's experiments (up to 256 nodes on the production machines).

Link rates follow Table I; effective per-node injection bandwidth:
  Leonardo  HDR   2x dual-port HDR100 -> 400 Gb/s higher-radix Dragonfly+
  CRESCO8   NDR   dual-port CX-7      -> 200 Gb/s, 1.67:1 blocking fat-tree
  LUMI      SS    4x200 Gb/s          -> 800 Gb/s Dragonfly
  HAICGU    EDR/RoCE 100 GE, single switch per 10-node partition
  Nanjing   RoCE-NSLB 200 GE, 2-leaf/2-spine
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.fabric import cc as cc_lib
from repro_torch.core.fabric import topology as topo_lib
from repro_torch.core.fabric.cc import CCParams, ROUTE_ADAPTIVE, ROUTE_FIXED
from repro_torch.core.fabric.routing import (POLICY_ADAPTIVE, POLICY_FIXED,
                                             STATIC_MODE_POLICY)


@dataclasses.dataclass(frozen=True)
class SystemPreset:
    name: str
    fabric: str
    make_topology: Callable[[int], topo_lib.Topology]
    cc: CCParams
    routing: int  # simulator dynamic routing mode
    static_routing: str  # path pre-assignment policy
    machine_nodes: int = 0  # full-machine size; 0 = allocation-sized testbed
    k_max: int = 4  # AR group size: candidate paths a flow may use
    description: str = ""


def leonardo() -> SystemPreset:
    return SystemPreset(
        name="leonardo", fabric="HDR InfiniBand",
        make_topology=lambda n: topo_lib.dragonfly_plus(
            n, leaves_per_group=4, spines_per_group=4, nodes_per_leaf=8,
            host_gbit=400.0, global_gbit=400.0, name="leonardo"),
        cc=cc_lib.infiniband("hdr"), routing=ROUTE_ADAPTIVE,
        static_routing="deterministic", machine_nodes=3456, k_max=7,
        description="BullSequana X2135, Dragonfly+, adaptive routing; "
                    "256 nodes = 7.4% of the Booster partition")


def cresco8() -> SystemPreset:
    return SystemPreset(
        name="cresco8", fabric="NDR InfiniBand",
        make_topology=lambda n: topo_lib.fat_tree(
            n, nodes_per_leaf=16, taper=1.67, host_gbit=200.0,
            name="cresco8"),
        cc=cc_lib.infiniband("ndr"), routing=ROUTE_ADAPTIVE,
        static_routing="deterministic", machine_nodes=760, k_max=4,
        description="1.67:1 blocking fat-tree (10 spines; AR group of 4); "
                    "256 nodes = 33.7% of machine")


def lumi() -> SystemPreset:
    return SystemPreset(
        name="lumi", fabric="Cray Slingshot",
        make_topology=lambda n: topo_lib.dragonfly(
            n, routers_per_group=8, nodes_per_router=4, host_gbit=800.0,
            global_gbit=800.0, name="lumi"),
        cc=cc_lib.slingshot(), routing=ROUTE_ADAPTIVE,
        static_routing="deterministic", machine_nodes=2978, k_max=8,
        description="HPE Cray EX, Dragonfly, per-flow congestion management, "
                    "global-aware fine-grained AR; 256 nodes = 8.6% of the "
                    "GPU partition")


def haicgu_ib() -> SystemPreset:
    return SystemPreset(
        name="haicgu_ib", fabric="EDR InfiniBand",
        make_topology=lambda n: topo_lib.single_switch(
            n, link_gbit=100.0, name="haicgu_ib"),
        cc=cc_lib.infiniband("edr"), routing=ROUTE_FIXED,
        static_routing="deterministic",
        description="TaiShan 200 nodes, Mellanox EDR single switch")


def haicgu_ce8850() -> SystemPreset:
    return SystemPreset(
        name="haicgu_ce8850", fabric="RoCE (CE8850)",
        make_topology=lambda n: topo_lib.single_switch(
            n, link_gbit=100.0, name="haicgu_ce8850"),
        cc=cc_lib.dcqcn(), routing=ROUTE_FIXED,
        static_routing="deterministic",
        description="CE8850 DCQCN: unstable feedback -> sawtooth (Obs. 1)")


def nanjing(nslb: bool = True) -> SystemPreset:
    return SystemPreset(
        name="nanjing_nslb" if nslb else "nanjing_ecmp",
        fabric="RoCE-NSLB (CE9855)",
        make_topology=lambda n: topo_lib.leaf_spine(
            n, n_leaf=2, n_spine=2, host_gbit=200.0, up_gbit=200.0,
            name="nanjing"),
        cc=cc_lib.ai_ecn(), routing=ROUTE_FIXED,
        static_routing="nslb" if nslb else "ecmp",
        description="2-leaf/2-spine 200GE; NSLB flow-matrix load balancing")


def tpu_pod(nx: int = 16, ny: int = 16) -> SystemPreset:
    """The target platform: deterministic-routing 2D torus (ICI)."""
    return SystemPreset(
        name="tpu_pod", fabric="TPU ICI",
        make_topology=lambda n: topo_lib.torus2d(nx, ny, link_gbit=400.0,
                                                 name="tpu_pod"),
        cc=cc_lib.slingshot(), routing=ROUTE_FIXED,
        static_routing="deterministic",
        description="2D torus, deterministic DOR routing — congestion must "
                    "be avoided statically by the collective schedule")


PRESETS = {
    "leonardo": leonardo,
    "cresco8": cresco8,
    "lumi": lumi,
    "haicgu_ib": haicgu_ib,
    "haicgu_ce8850": haicgu_ce8850,
    "nanjing_nslb": lambda: nanjing(True),
    "nanjing_ecmp": lambda: nanjing(False),
    "tpu_pod": tpu_pod,
}


def get_system(name: str) -> SystemPreset:
    return PRESETS[name]()


def default_policy(system: SystemPreset) -> int:
    """Traced routing-policy id equivalent to the preset's legacy
    (routing, static_routing) pair — bit-identical by construction:
    adaptive presets route per-step; fixed presets replay the static
    table their ``static_routing`` mode produced (which the traced
    ecmp/nslb policies read straight from the geometry)."""
    if system.routing == ROUTE_ADAPTIVE:
        return POLICY_ADAPTIVE
    return STATIC_MODE_POLICY.get(system.static_routing, POLICY_FIXED)
