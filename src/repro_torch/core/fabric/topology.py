"""Fabric topologies with structured path enumeration.

Each constructor returns a :class:`Topology` with directed capacitated links and
a per-(src,dst) candidate-path generator that exploits the topology's
structure (fat-tree: one path per spine; dragonfly: per global link; ...)
instead of generic graph search. Paths are lists of link indices.

Modeled systems (paper Table I): CRESCO8 blocking fat-tree, Leonardo
Dragonfly+, LUMI Dragonfly, HAICGU single switch, Nanjing 2-leaf/2-spine,
plus a TPU 2D-torus for the target platform.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np

Link = Tuple[object, object]  # (endpoint_a, endpoint_b) directed


@dataclasses.dataclass
class Topology:
    name: str
    n_nodes: int
    caps: np.ndarray  # (L,) link capacity, bytes/s
    link_names: List[Link]
    link_index: Dict[Link, int]
    path_fn: Callable[[int, int], List[List[int]]]  # candidate paths
    link_src_switch: np.ndarray  # (L,) int id of the switch feeding each link
    meta: dict

    @property
    def n_links(self) -> int:
        return len(self.caps)

    def paths(self, src: int, dst: int) -> List[List[int]]:
        if src == dst:
            return [[]]
        return self.path_fn(src, dst)


class _Builder:
    def __init__(self):
        self.links: List[Link] = []
        self.caps: List[float] = []
        self.index: Dict[Link, int] = {}

    def add(self, a, b, cap_gbit: float) -> int:
        key = (a, b)
        if key in self.index:
            return self.index[key]
        idx = len(self.links)
        self.links.append(key)
        self.caps.append(cap_gbit * 1e9 / 8.0)  # Gb/s -> B/s
        self.index[key] = idx
        return idx

    def finish(self, name, n_nodes, path_fn, meta) -> Topology:
        src_sw = []
        switches: Dict[object, int] = {}
        for a, _ in self.links:
            if isinstance(a, tuple) and a[0] == "h":
                src_sw.append(-1)  # host injection link
            else:
                src_sw.append(switches.setdefault(a, len(switches)))
        return Topology(name, n_nodes, np.asarray(self.caps), self.links,
                        self.index, path_fn, np.asarray(src_sw, np.int32),
                        meta)


def _h(i):
    return ("h", i)


# --------------------------------------------------------------------------


def single_switch(n_nodes: int, link_gbit: float = 100.0,
                  name: str = "single_switch") -> Topology:
    b = _Builder()
    sw = ("sw", 0)
    for i in range(n_nodes):
        b.add(_h(i), sw, link_gbit)
        b.add(sw, _h(i), link_gbit)

    def path_fn(src, dst):
        return [[b.index[(_h(src), sw)], b.index[(sw, _h(dst))]]]

    return b.finish(name, n_nodes, path_fn, {"link_gbit": link_gbit})


def leaf_spine(n_nodes: int, n_leaf: int = 2, n_spine: int = 2,
               host_gbit: float = 200.0, up_gbit: float = 200.0,
               n_parallel: int = 2, name: str = "leaf_spine") -> Topology:
    """Nanjing lab: 2-leaf / 2-spine 200GE, ``n_parallel`` uplinks per
    leaf-spine pair (NSLB exploits the multiple path configurations)."""
    b = _Builder()
    # ceil so any node count maps to a valid leaf (matches fat_tree)
    per_leaf = (n_nodes + n_leaf - 1) // n_leaf
    for i in range(n_nodes):
        lf = ("leaf", i // per_leaf)
        b.add(_h(i), lf, host_gbit)
        b.add(lf, _h(i), host_gbit)
    for l in range(n_leaf):
        for s in range(n_spine):
            for p in range(n_parallel):
                b.add(("leaf", l), ("spine", s, p), up_gbit)
                b.add(("spine", s, p), ("leaf", l), up_gbit)

    def path_fn(src, dst):
        ls, ld = ("leaf", src // per_leaf), ("leaf", dst // per_leaf)
        inj, ej = b.index[(_h(src), ls)], b.index[(ld, _h(dst))]
        if ls == ld:
            return [[inj, ej]]
        return [[inj, b.index[(ls, ("spine", s, p))],
                 b.index[(("spine", s, p), ld)], ej]
                for s in range(n_spine) for p in range(n_parallel)]

    return b.finish(name, n_nodes, path_fn,
                    {"n_leaf": n_leaf, "n_spine": n_spine,
                     "n_parallel": n_parallel})


def fat_tree(n_nodes: int, nodes_per_leaf: int = 16, taper: float = 1.67,
             host_gbit: float = 200.0, name: str = "fat_tree") -> Topology:
    """2-level blocking fat-tree (CRESCO8: 1.67:1 taper, NDR 200 Gb/s)."""
    b = _Builder()
    n_leaf = (n_nodes + nodes_per_leaf - 1) // nodes_per_leaf
    n_spine = max(1, round(nodes_per_leaf / taper))
    for i in range(n_nodes):
        lf = ("leaf", i // nodes_per_leaf)
        b.add(_h(i), lf, host_gbit)
        b.add(lf, _h(i), host_gbit)
    for l in range(n_leaf):
        for s in range(n_spine):
            b.add(("leaf", l), ("spine", s), host_gbit)
            b.add(("spine", s), ("leaf", l), host_gbit)

    def path_fn(src, dst):
        ls, ld = ("leaf", src // nodes_per_leaf), ("leaf", dst // nodes_per_leaf)
        inj, ej = b.index[(_h(src), ls)], b.index[(ld, _h(dst))]
        if ls == ld:
            return [[inj, ej]]
        return [[inj, b.index[(ls, ("spine", s))],
                 b.index[(("spine", s), ld)], ej] for s in range(n_spine)]

    return b.finish(name, n_nodes, path_fn,
                    {"n_leaf": n_leaf, "n_spine": n_spine, "taper": taper})


def dragonfly(n_nodes: int, routers_per_group: int = 8,
              nodes_per_router: int = 4, host_gbit: float = 200.0,
              global_gbit: float = 200.0, n_valiant: int = 4,
              name: str = "dragonfly") -> Topology:
    """Dragonfly (LUMI-like): all-to-all routers inside a group, one global
    link between each pair of groups (assigned round-robin to routers)."""
    b = _Builder()
    per_group = routers_per_group * nodes_per_router
    n_groups = (n_nodes + per_group - 1) // per_group

    def router_of(i):
        return ("r", i // per_group, (i % per_group) // nodes_per_router)

    for i in range(n_nodes):
        b.add(_h(i), router_of(i), host_gbit)
        b.add(router_of(i), _h(i), host_gbit)
    for g in range(n_groups):
        for r1 in range(routers_per_group):
            for r2 in range(routers_per_group):
                if r1 != r2:
                    b.add(("r", g, r1), ("r", g, r2), host_gbit)
    # one global link per router per destination group (round-robin base +
    # parallel options) — Dragonfly provisions several globals per pair
    glinks: Dict[Tuple[int, int], list] = {}
    n_par = min(4, routers_per_group)
    for g1 in range(n_groups):
        for g2 in range(n_groups):
            if g1 == g2:
                continue
            opts = []
            for j in range(n_par):
                r1 = (g1 + g2 + j) % routers_per_group
                r2 = (g1 + g2 + j) % routers_per_group
                b.add(("r", g1, r1), ("r", g2, r2), global_gbit)
                opts.append((r1, r2))
            glinks[(g1, g2)] = opts

    def path_fn(src, dst):
        rs, rd = router_of(src), router_of(dst)
        gs, gd = rs[1], rd[1]
        inj, ej = b.index[(_h(src), rs)], b.index[(rd, _h(dst))]
        paths = []
        if gs == gd:
            if rs == rd:
                return [[inj, ej]]
            return [[inj, b.index[(rs, rd)], ej]]
        # minimal: rs -> gw_src -> gw_dst -> rd, one per parallel global link
        for r1, r2 in glinks[(gs, gd)]:
            p = [inj]
            if rs[2] != r1:
                p.append(b.index[(rs, ("r", gs, r1))])
            p.append(b.index[(("r", gs, r1), ("r", gd, r2))])
            if rd[2] != r2:
                p.append(b.index[(("r", gd, r2), rd)])
            p.append(ej)
            paths.append(p)
        # non-minimal (Valiant) via intermediate groups — the path diversity
        # that lets AR absorb AlltoAll transit contention (paper §II)
        seen = {gs, gd}
        stride = max(1, n_groups // (n_valiant + 1))
        for j in range(n_groups):
            gi = (min(gs, gd) + 1 + j * stride) % max(n_groups, 1)
            if gi in seen or len(paths) >= len(glinks.get((gs, gd), [0])) \
                    + n_valiant:
                continue
            seen.add(gi)
            ra, rb = glinks[(gs, gi)][j % n_par]
            rc, rdd = glinks[(gi, gd)][j % n_par]
            p = [inj]
            if rs[2] != ra:
                p.append(b.index[(rs, ("r", gs, ra))])
            p.append(b.index[(("r", gs, ra), ("r", gi, rb))])
            if rb != rc:
                p.append(b.index[(("r", gi, rb), ("r", gi, rc))])
            p.append(b.index[(("r", gi, rc), ("r", gd, rdd))])
            if rd[2] != rdd:
                p.append(b.index[(("r", gd, rdd), rd)])
            p.append(ej)
            paths.append(p)
        return paths

    return b.finish(name, n_nodes, path_fn,
                    {"n_groups": n_groups, "routers_per_group": routers_per_group})


def dragonfly_plus(n_nodes: int, leaves_per_group: int = 4,
                   spines_per_group: int = 4, nodes_per_leaf: int = 8,
                   host_gbit: float = 100.0, global_gbit: float = 100.0,
                   intra_factor: float = 2.0, n_valiant: int = 6,
                   name: str = "dragonfly_plus") -> Topology:
    """Dragonfly+ (Leonardo-like): groups are leaf/spine bipartite (non-
    blocking intra-group: uplink bw = downlink bw); spines hold the
    inter-group links (tapered globally)."""
    b = _Builder()
    per_group = leaves_per_group * nodes_per_leaf
    n_groups = (n_nodes + per_group - 1) // per_group
    up_gbit = host_gbit * nodes_per_leaf / spines_per_group \
        if intra_factor <= 0 else host_gbit * intra_factor

    def leaf_of(i):
        return ("lf", i // per_group, (i % per_group) // nodes_per_leaf)

    for i in range(n_nodes):
        b.add(_h(i), leaf_of(i), host_gbit)
        b.add(leaf_of(i), _h(i), host_gbit)
    for g in range(n_groups):
        for l in range(leaves_per_group):
            for s in range(spines_per_group):
                b.add(("lf", g, l), ("sp", g, s), up_gbit)
                b.add(("sp", g, s), ("lf", g, l), up_gbit)
    for g1 in range(n_groups):
        for g2 in range(n_groups):
            if g1 != g2:
                s = (g1 + g2) % spines_per_group
                b.add(("sp", g1, s), ("sp", g2, s), global_gbit)

    def path_fn(src, dst):
        ls, ld = leaf_of(src), leaf_of(dst)
        gs, gd = ls[1], ld[1]
        inj, ej = b.index[(_h(src), ls)], b.index[(ld, _h(dst))]
        if ls == ld:
            return [[inj, ej]]
        if gs == gd:
            return [[inj, b.index[(ls, ("sp", gs, s))],
                     b.index[(("sp", gs, s), ld)], ej]
                    for s in range(spines_per_group)]
        s = (gs + gd) % spines_per_group
        base = [inj, b.index[(ls, ("sp", gs, s))],
                b.index[(("sp", gs, s), ("sp", gd, s))],
                b.index[(("sp", gd, s), ld)], ej]
        paths = [base]
        # non-minimal through other groups' spine pairs, sampled across the
        # machine so concurrent flows can fan out over many transit groups
        stride = max(1, n_groups // (n_valiant + 1))
        seen = {gs, gd}
        for j in range(n_groups):
            gi = (min(gs, gd) + 1 + j * stride) % n_groups
            if gi in seen or len(paths) >= 1 + n_valiant:
                continue
            seen.add(gi)
            s1 = (gs + gi) % spines_per_group
            s2 = (gi + gd) % spines_per_group
            p = [inj, b.index[(ls, ("sp", gs, s1))],
                 b.index[(("sp", gs, s1), ("sp", gi, s1))]]
            if s1 != s2:
                p += [b.index[(("sp", gi, s1), ("lf", gi, 0))],
                      b.index[(("lf", gi, 0), ("sp", gi, s2))]]
            p += [b.index[(("sp", gi, s2), ("sp", gd, s2))],
                  b.index[(("sp", gd, s2), ld)], ej]
            paths.append(p)
        return paths

    return b.finish(name, n_nodes, path_fn,
                    {"n_groups": n_groups, "leaves_per_group": leaves_per_group,
                     "spines_per_group": spines_per_group})


def torus2d(nx: int, ny: int, link_gbit: float = 400.0,
            name: str = "torus2d") -> Topology:
    """TPU-style 2D torus; hosts are the routers (ICI), DOR X-then-Y routing."""
    b = _Builder()
    n = nx * ny

    def xy(i):
        return i % nx, i // nx

    for i in range(n):
        x, y = xy(i)
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            j = ((x + dx) % nx) + ((y + dy) % ny) * nx
            b.add(_h(i), _h(j), link_gbit)

    def hop(a, b_):
        return b.index[(_h(a), _h(b_))]

    def path_fn(src, dst):
        # dimension-ordered, minimal (both X directions tie-broken shortest)
        def walk(i, j):
            xs, ys = xy(i)
            xd, yd = xy(j)
            links = []
            while xs != xd:
                step = 1 if (xd - xs) % nx <= nx // 2 else -1
                nxt = ((xs + step) % nx) + ys * nx
                links.append(hop(xs + ys * nx, nxt))
                xs = (xs + step) % nx
            while ys != yd:
                step = 1 if (yd - ys) % ny <= ny // 2 else -1
                nxt = xs + ((ys + step) % ny) * nx
                links.append(hop(xs + ys * nx, nxt))
                ys = (ys + step) % ny
            return links

        return [walk(src, dst)]

    return b.finish(name, n, path_fn, {"nx": nx, "ny": ny})


# Named families, for the property tests and for callers that pick a
# topology by name.
FAMILIES: Dict[str, Callable[..., Topology]] = {
    "single_switch": single_switch,
    "leaf_spine": leaf_spine,
    "fat_tree": fat_tree,
    "dragonfly": dragonfly,
    "dragonfly_plus": dragonfly_plus,
}


def make_family(family: str, n_nodes: int, **kwargs) -> Topology:
    """Build one named topology family at ``n_nodes`` (kwargs go to the
    family's builder)."""
    if family not in FAMILIES:
        raise KeyError(f"unknown topology family {family!r}; "
                       f"known: {sorted(FAMILIES)}")
    return FAMILIES[family](n_nodes, **kwargs)
