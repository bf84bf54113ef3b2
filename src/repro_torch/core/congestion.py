"""Congestion-injection harness (paper §III) on the traffic-program IR.

* interleaved victim/aggressor node split (§III-A);
* aggressor patterns: AlltoAll and Incast, run in an endless loop;
* congestion profiles (steady, bursty, ramp, random, mixes) and link-fault
  events (outage, flap, degrade, jitter, switch outage), re-exported from
  envelopes.py.

Every experiment is a program of jobs (traffic.JobSpec); the paper's
victim/aggressor setup is the two-job special case. The functions here
are host-side numpy and bind a program to a topology as a
:class:`~repro_torch.core.fabric.simulator.FlowSet`.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core import traffic
from repro_torch.core.collectives import wire_bytes_model
from repro_torch.core.envelopes import (ENV_COMPONENTS,  # noqa: F401
                                        FAULT_EVENTS, FAULT_FIELDS,
                                        GROUP_EDGE_DOWN, GROUP_EDGE_UP,
                                        GROUP_FABRIC, GROUP_HOT,
                                        GROUP_SWITCH, FaultEvent, Profile,
                                        bursty, degrade, envelope_at,
                                        envelope_np, fault_scale_at,
                                        fault_table, flap, jitter,
                                        multi_tenant, needs_fault_table,
                                        no_congestion, no_fault_table,
                                        outage, ramp, random_onoff, steady,
                                        switch_outage, with_faults,
                                        with_node_cap)
from repro_torch.core.fabric.routing import assign_paths
from repro_torch.core.fabric.simulator import FlowSet, pack_paths
from repro_torch.core.fabric.topology import Topology
from repro_torch.core.traffic import JobSpec  # noqa: F401  (re-export)


def interleaved_split(n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §III-A: alternate nodes between victims and aggressors."""
    ids = np.arange(n_nodes)
    return ids[ids % 2 == 0], ids[ids % 2 == 1]


def collective_flows(nodes: Sequence[int], kind: str,
                     vector_bytes: float) -> List[Tuple[int, int, float]]:
    """(src, dst, bytes_per_iteration) triples for one flattened
    collective (the traffic IR's single-phase lowering): ring AllGather
    ((n-1)/n of the vector along the ring), linear AlltoAll (all pairs,
    V/n each), ring AllReduce (twice the ring traffic), Incast (every node
    to one)."""
    return traffic._flat_flows(nodes, kind, vector_bytes)


def build_program_flowset(topo: Topology, jobs: Sequence[traffic.JobSpec],
                          routing_mode: str = "deterministic",
                          k_max: int = 4, seed: int = 0,
                          validate: bool = True,
                          pad_to: Tuple[int, int, int] = None,
                          policy_tables: bool = False) -> FlowSet:
    """Compile a multi-job traffic program and bind it to a topology:
    per-flow paths, NIC caps, and the packed phase tables the simulator
    executes. ``pad_to=(n_flows, n_jobs, n_phases)`` pads the program to
    bucket dims (traffic.pad_program; inert 0-byte rows of an
    envelope-gated pad job); validation runs on the real prefix either
    way."""
    prog = traffic.compile_programs(jobs, validate=validate)
    if pad_to is not None:
        prog = traffic.pad_program(prog, n_flows=pad_to[0],
                                   n_jobs=pad_to[1], n_phases=pad_to[2])
        if validate:
            traffic.check_program(prog)  # still exact on the valid prefix
    return bind_program(topo, prog, routing_mode=routing_mode, k_max=k_max,
                        seed=seed, policy_tables=policy_tables)


def bind_program(topo: Topology, prog: traffic.TrafficProgram,
                 routing_mode: str = "deterministic", k_max: int = 4,
                 seed: int = 0, policy_tables: bool = False) -> FlowSet:
    """Bind a compiled TrafficProgram to a topology. ``policy_tables``
    also computes the ECMP/NSLB tables a per-cell policy may select."""
    src_dst = [(int(s), int(d)) for s, d in zip(prog.src, prog.dst)]
    paths_per_flow = [topo.paths(s, d) for s, d in src_dst]
    sink = len(topo.caps)
    paths, n_paths, plen = pack_paths(paths_per_flow, sink, k_max)
    is_victim = ~prog.env_gated[prog.flow_job] if prog.n_flows \
        else np.zeros((0,), bool)
    choice = assign_paths(routing_mode, src_dst, paths_per_flow,
                          len(topo.caps), seed)
    alt = {routing_mode: choice}
    if policy_tables:
        for mode in ("ecmp", "nslb"):
            if mode not in alt:
                alt[mode] = assign_paths(mode, src_dst, paths_per_flow,
                                         len(topo.caps), seed)
    # injection-link capacity per flow (the host's NIC rate)
    host_caps = np.array(
        [topo.caps[p[0][0]] if p and p[0] else topo.caps.max()
         for p in paths_per_flow])
    src_id = np.array([s for s, _ in src_dst], np.int32)
    return FlowSet(paths=paths, n_paths=n_paths, path_len=plen,
                   is_victim=is_victim,
                   bytes_per_iter=prog.bytes_per_phase,
                   fixed_choice=choice, host_caps=host_caps, src_id=src_id,
                   ecmp_choice=alt.get("ecmp"), nslb_choice=alt.get("nslb"),
                   flow_job=prog.flow_job, flow_phase=prog.flow_phase,
                   n_phases=prog.n_phases, phase_gap=prog.phase_gap,
                   sweep_mask=prog.sweep_mask, job_names=prog.job_names())


def build_flowset(topo: Topology, victim_nodes, aggressor_nodes,
                  victim_coll: str, aggr_coll: str, vector_bytes: float,
                  routing_mode: str = "deterministic",
                  k_max: int = 4, seed: int = 0,
                  phased: bool = False,
                  policy_tables: bool = False) -> FlowSet:
    """The paper's two-job program: one victim collective (flattened by
    default; ``phased=True`` lowers its step schedule) plus an endless
    envelope-gated aggressor on the interleaved node split."""
    jobs = [traffic.JobSpec("victim", victim_coll, vector_bytes,
                            nodes=tuple(int(x) for x in victim_nodes),
                            phased=phased)]
    if aggr_coll and len(aggressor_nodes) >= 2:
        jobs.append(traffic.JobSpec(
            "aggressor", aggr_coll,
            nodes=tuple(int(x) for x in aggressor_nodes),
            endless=True, envelope_gated=True, sweep_bytes=False))
    return build_program_flowset(topo, jobs, routing_mode=routing_mode,
                                 k_max=k_max, seed=seed,
                                 policy_tables=policy_tables)


def latency_model(kind: str, n: int, per_step_s: float = 2e-6) -> float:
    """Fixed per-iteration latency: serialized schedule steps x per-msg lat."""
    steps = wire_bytes_model(traffic.WIRE_KIND[kind], n, 1.0)["steps"]
    return steps * per_step_s
