"""Partitioned Boolean Quadratic Programming solver (NeoCPU §3.3.2).

The paper reduces the global layout search on complicated graphs (SSD's
concat blocks) to PBQP, the formulation used for register allocation
[Hames & Scholz 2006], and solves it with the standard reduction scheme:

    R0  — degree-0 node: pick its cheapest alternative.
    RI  — degree-1 node: fold its cost vector through the edge matrix into
          the neighbour's vector.  Exact.
    RII — degree-2 node: fold into a (possibly new) edge between the two
          neighbours.  Exact.
    RN  — heuristic for degree ≥ 3: greedily fix the max-degree node to its
          locally cheapest alternative, then fold its edges.

Graphs reducible by R0–RII alone (chains, trees, series-parallel — i.e.
VGG, ResNet, DenseNet blocks) are solved *optimally*; RN is only invoked on
genuinely irreducible structure (SSD-style multi-concat), matching the
paper's "at least 88% of the best" empirical bound.

The instance is generic: node ``i`` has a cost vector over its alternatives,
edge ``(i, j)`` a cost matrix.  The planner instantiates alternatives =
(ic_bn, oc_bn) schemes and matrices = layout-transform times.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Tuple

import numpy as np

NodeId = Hashable


class PBQPGraph:
    def __init__(self) -> None:
        self.costs: Dict[NodeId, np.ndarray] = {}
        self.edges: Dict[Tuple[NodeId, NodeId], np.ndarray] = {}
        self.adj: Dict[NodeId, set] = {}

    # -- construction --------------------------------------------------------
    def add_node(self, u: NodeId, cost_vector: np.ndarray) -> None:
        if u in self.costs:
            raise ValueError(f"duplicate node {u!r}")
        self.costs[u] = np.asarray(cost_vector, dtype=np.float64).copy()
        self.adj[u] = set()

    def add_edge(self, u: NodeId, v: NodeId, matrix: np.ndarray) -> None:
        """Accumulates if the edge exists (parallel edges sum, per PBQP)."""
        if u == v:
            # self-edge: diagonal folds into the node's own cost vector
            m = np.asarray(matrix, dtype=np.float64)
            self.costs[u] += np.diag(m)
            return
        key, mat = self._orient(u, v, np.asarray(matrix, dtype=np.float64))
        if key in self.edges:
            self.edges[key] = self.edges[key] + mat
        else:
            self.edges[key] = mat.copy()
            self.adj[u].add(v)
            self.adj[v].add(u)

    @staticmethod
    def _orient(u, v, mat):
        return ((u, v), mat) if repr(u) <= repr(v) else ((v, u), mat.T)

    def matrix(self, u: NodeId, v: NodeId) -> np.ndarray:
        """Edge matrix oriented (u-alternatives rows, v-alternatives cols)."""
        key, _ = self._orient(u, v, np.zeros((1, 1)))
        mat = self.edges[key]
        return mat if key == (u, v) else mat.T

    def _drop_edge(self, u: NodeId, v: NodeId) -> None:
        key, _ = self._orient(u, v, np.zeros((1, 1)))
        del self.edges[key]
        self.adj[u].discard(v)
        self.adj[v].discard(u)


@dataclasses.dataclass
class _Reduction:
    kind: str                      # "R0" | "RI" | "RII" | "RN"
    node: NodeId
    neighbors: Tuple[NodeId, ...]  # frozen at reduction time
    # decision[(y, z, ...)] -> best alternative of `node` given the
    # neighbours' eventual choices; for R0/RN a single int.
    decision: object


@dataclasses.dataclass
class PBQPSolution:
    assignment: Dict[NodeId, int]
    objective: float
    exact: bool   # True iff no RN reduction was needed


def solve(graph: PBQPGraph) -> PBQPSolution:
    g = graph
    stack: List[_Reduction] = []
    exact = True
    live = set(g.costs)

    def degree(u):
        return len(g.adj[u])

    while live:
        # prefer exact reductions, lowest degree first
        u = min(live, key=lambda n: (min(degree(n), 3), repr(n)))
        d = degree(u)
        if d == 0:
            best = int(np.argmin(g.costs[u]))
            stack.append(_Reduction("R0", u, (), best))
            live.discard(u)
        elif d == 1:
            (v,) = tuple(g.adj[u])
            m = g.matrix(u, v)                       # (|u|, |v|)
            tot = g.costs[u][:, None] + m            # (|u|, |v|)
            g.costs[v] += tot.min(axis=0)
            decision = tot.argmin(axis=0)            # per v-alternative
            g._drop_edge(u, v)
            stack.append(_Reduction("RI", u, (v,), decision))
            live.discard(u)
        elif d == 2:
            v, w = sorted(g.adj[u], key=repr)
            muv = g.matrix(u, v)                     # (|u|, |v|)
            muw = g.matrix(u, w)                     # (|u|, |w|)
            # tot[x, y, z] = c_u(x) + C_uv(x,y) + C_uw(x,z)
            tot = (g.costs[u][:, None, None] + muv[:, :, None]
                   + muw[:, None, :])
            delta = tot.min(axis=0)                  # (|v|, |w|)
            decision = tot.argmin(axis=0)
            g._drop_edge(u, v)
            g._drop_edge(u, w)
            g.add_edge(v, w, delta)
            stack.append(_Reduction("RII", u, (v, w), decision))
            live.discard(u)
        else:
            # RN heuristic: fix the max-degree node to its local minimum
            exact = False
            u = max(live, key=lambda n: (degree(n), repr(n)))
            neigh = sorted(g.adj[u], key=repr)
            local = g.costs[u].copy()
            for v in neigh:
                local += g.matrix(u, v).min(axis=1)
            best = int(np.argmin(local))
            for v in neigh:
                g.costs[v] += g.matrix(u, v)[best]
                g._drop_edge(u, v)
            stack.append(_Reduction("RN", u, (), best))
            live.discard(u)

    # back-propagation in reverse reduction order
    assignment: Dict[NodeId, int] = {}
    for red in reversed(stack):
        if red.kind in ("R0", "RN"):
            assignment[red.node] = red.decision
        elif red.kind == "RI":
            (v,) = red.neighbors
            assignment[red.node] = int(red.decision[assignment[v]])
        else:  # RII
            v, w = red.neighbors
            assignment[red.node] = int(
                red.decision[assignment[v], assignment[w]])

    obj = objective(graph_costs=graph, assignment=assignment)
    return PBQPSolution(assignment=assignment, objective=obj, exact=exact)


def objective(graph_costs: PBQPGraph, assignment: Dict[NodeId, int]) -> float:
    """Evaluate an assignment against the *original* instance.  Note: solve()
    mutates vectors/edges, so callers keep a pristine copy (see solve_copy)."""
    total = 0.0
    for u, vec in graph_costs.costs.items():
        total += float(vec[assignment[u]])
    for (u, v), m in graph_costs.edges.items():
        total += float(m[assignment[u], assignment[v]])
    return total


def _clone(g: PBQPGraph) -> PBQPGraph:
    c = PBQPGraph()
    c.costs = {k: v.copy() for k, v in g.costs.items()}
    c.edges = {k: v.copy() for k, v in g.edges.items()}
    c.adj = {k: set(v) for k, v in g.adj.items()}
    return c


def solve_copy(g: PBQPGraph) -> PBQPSolution:
    """Solve without mutating ``g``; objective evaluated on the original."""
    sol = solve(_clone(g))
    return PBQPSolution(assignment=sol.assignment,
                        objective=objective(g, sol.assignment),
                        exact=sol.exact)


def brute_force(g: PBQPGraph) -> PBQPSolution:
    """Exponential reference solver for tests."""
    import itertools

    nodes = sorted(g.costs, key=repr)
    sizes = [len(g.costs[n]) for n in nodes]
    best, best_asgn = np.inf, None
    for combo in itertools.product(*[range(s) for s in sizes]):
        asgn = dict(zip(nodes, combo))
        o = objective(g, asgn)
        if o < best:
            best, best_asgn = o, asgn
    return PBQPSolution(assignment=best_asgn, objective=best, exact=True)
