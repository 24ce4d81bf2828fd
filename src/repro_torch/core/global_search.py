"""Global optimization-scheme search (NeoCPU §3.3.2, Algorithm 2).

Each CONV node carries a cost vector over its candidate schemes (the best
local-search time per (ic_bn, oc_bn) pair); each data-dependency edge
between CONVs carries a transform-cost matrix (zero on entries where the
producer's output layout equals the consumer's input layout).  Choose one
scheme per CONV minimizing Σ node costs + Σ edge costs.

Two solvers, matching the paper:

* ``dp_search`` — exact dynamic programming over the topologically ordered
  graph.  The DP state is the joint scheme choice of the *frontier* (nodes
  whose successors are not all processed yet); for chain-like models the
  frontier is one node and this is exactly Algorithm 2.  For graphs with
  heavy fan-in/fan-out the state count explodes (the paper: "the number of
  states can reach the order of trillions" for SSD) — a state budget aborts
  the DP.
* PBQP fallback — the register-allocation-style approximation of §3.3.2,
  implemented in ``core/pbqp.py``.

``solve`` mirrors the paper's policy: try DP, and switch to the
approximation when DP exceeds its budget (paper: 5 minutes; here: a state
count, deterministic in this container).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import pbqp


class Intractable(Exception):
    """DP state budget exceeded — switch to the approximation (§3.3.2)."""


@dataclasses.dataclass
class SchemeProblem:
    """node -> scheme-cost vector; directed edge (u, v) -> transform matrix
    of shape (len(schemes_u), len(schemes_v)); topo = topological order."""

    node_costs: Dict[str, np.ndarray]
    edge_costs: Dict[Tuple[str, str], np.ndarray]
    topo: List[str]

    def predecessors(self, v: str) -> List[str]:
        return [u for (u, w) in self.edge_costs if w == v]

    def successors(self, u: str) -> List[str]:
        return [w for (v, w) in self.edge_costs if v == u]

    def validate(self) -> None:
        pos = {n: i for i, n in enumerate(self.topo)}
        assert set(pos) == set(self.node_costs), "topo != nodes"
        for (u, v), m in self.edge_costs.items():
            assert pos[u] < pos[v], f"edge {u}->{v} violates topo order"
            assert m.shape == (len(self.node_costs[u]),
                               len(self.node_costs[v])), (u, v, m.shape)


@dataclasses.dataclass
class SchemeSolution:
    assignment: Dict[str, int]
    objective: float
    method: str  # "dp" | "pbqp" | "brute"
    dp_states_peak: int = 0


def evaluate(problem: SchemeProblem, assignment: Dict[str, int]) -> float:
    total = 0.0
    for n, vec in problem.node_costs.items():
        total += float(vec[assignment[n]])
    for (u, v), m in problem.edge_costs.items():
        total += float(m[assignment[u], assignment[v]])
    return total


# ---------------------------------------------------------------------------
# Exact DP (Algorithm 2 generalized to DAGs via frontier states)
# ---------------------------------------------------------------------------

def dp_search(problem: SchemeProblem, max_states: int = 200_000
              ) -> SchemeSolution:
    problem.validate()
    topo = problem.topo
    succ = {n: problem.successors(n) for n in topo}
    pos = {n: i for i, n in enumerate(topo)}

    # frontier states: {node: choice} (as a frozenset of items) -> cost.
    # Back-pointers (parent state key + this node's choice) per level let us
    # reconstruct the full assignment without copying it per expansion.
    states: Dict[frozenset, float] = {frozenset(): 0.0}
    back: List[Dict[frozenset, Tuple[frozenset, int]]] = []
    peak = 1

    for idx, n in enumerate(topo):
        preds = problem.predecessors(n)
        k = len(problem.node_costs[n])
        retire = [m for m in topo[:idx + 1]
                  if all(pos[s] <= idx for s in succ[m])]
        retire_set = set(retire)
        new_states: Dict[frozenset, float] = {}
        new_back: Dict[frozenset, Tuple[frozenset, int]] = {}
        for key, cost in states.items():
            frontier = dict(key)
            for choice in range(k):
                c = cost + float(problem.node_costs[n][choice])
                for p in preds:
                    c += float(
                        problem.edge_costs[(p, n)][frontier[p], choice])
                nf = {m: ch for m, ch in frontier.items()
                      if m not in retire_set}
                if n not in retire_set:
                    nf[n] = choice
                nk = frozenset(nf.items())
                prev = new_states.get(nk)
                if prev is None or c < prev:
                    new_states[nk] = c
                    new_back[nk] = (key, choice)
                if len(new_states) > max_states:   # bail early
                    raise Intractable(
                        f"DP frontier exploded at {n!r}: >{max_states} states")
        states = new_states
        back.append(new_back)
        peak = max(peak, len(states))

    # reconstruct the argmin assignment by walking back-pointers
    best_key = min(states, key=states.get)
    best_cost = states[best_key]
    assignment: Dict[str, int] = {}
    key = best_key
    for idx in range(len(topo) - 1, -1, -1):
        key, choice = back[idx][key]
        assignment[topo[idx]] = choice
    return SchemeSolution(assignment=assignment, objective=best_cost,
                          method="dp", dp_states_peak=peak)


# ---------------------------------------------------------------------------
# PBQP reduction (§3.3.2's approximation) and the combined policy
# ---------------------------------------------------------------------------

def to_pbqp(problem: SchemeProblem) -> pbqp.PBQPGraph:
    g = pbqp.PBQPGraph()
    for n, vec in problem.node_costs.items():
        g.add_node(n, vec)
    for (u, v), m in problem.edge_costs.items():
        g.add_edge(u, v, m)
    return g


def pbqp_search(problem: SchemeProblem) -> SchemeSolution:
    sol = pbqp.solve_copy(to_pbqp(problem))
    method = "pbqp-exact" if sol.exact else "pbqp"
    return SchemeSolution(assignment=dict(sol.assignment),
                          objective=evaluate(problem, sol.assignment),
                          method=method)


def solve(problem: SchemeProblem, dp_state_budget: int = 200_000
          ) -> SchemeSolution:
    """Paper policy: DP first, approximation on blow-up."""
    try:
        return dp_search(problem, max_states=dp_state_budget)
    except Intractable:
        return pbqp_search(problem)


def brute_force(problem: SchemeProblem) -> SchemeSolution:
    nodes = problem.topo
    sizes = [len(problem.node_costs[n]) for n in nodes]
    best, best_asgn = np.inf, None
    for combo in itertools.product(*[range(s) for s in sizes]):
        asgn = dict(zip(nodes, combo))
        o = evaluate(problem, asgn)
        if o < best:
            best, best_asgn = o, asgn
    return SchemeSolution(assignment=best_asgn, objective=best,
                          method="brute")
