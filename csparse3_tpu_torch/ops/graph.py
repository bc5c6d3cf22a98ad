"""Connected components ("islands") of a sparsity pattern on the matrix's
device, as the JAX package's ``csparse3_tpu/ops/graph.py``.

Min-label propagation with pointer jumping over the symmetrized entry
stream, each round

    label[v] <- min(label[v], min over neighbours u of label[u])
    label    <- min(label, label[label])

as torch ops (a gather, ``scatter_reduce_(reduce='amin')``, a gather and
a ``minimum``), until a round changes nothing: one host read a round where
the JAX package runs a ``lax.while_loop``.  At the fixpoint every node
holds the least node of its component; components are then numbered by
that node, and the labels and the per-component index lists come back as
host numpy, as the JAX package returns them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..types import CSC

__all__ = ["islands", "component_labels", "propagate_labels", "edge_stream",
           "label_round"]


def _square(a: CSC):
    if a.m != a.n:
        raise ValueError("islands expects a square (adjacency-like) matrix")


def edge_stream(a: CSC):
    """(src, dst): the entries of the square A as directed edges both ways,
    int64 tensors on the matrix's device."""
    _square(a)
    rows, cols = a.entry_streams()
    return torch.cat([rows, cols]), torch.cat([cols, rows])


def label_round(labels, src, dst):
    """One round: each node takes the least label among itself and its
    in-neighbours, then the label of its label."""
    new = labels.scatter_reduce(0, dst, labels[src], reduce="amin",
                                include_self=True)
    return torch.minimum(new, new[new])


@torch.inference_mode()
def propagate_labels(a: CSC):
    """(least node of each node's component as an int64 tensor on the
    matrix's device, rounds taken), the pattern of the square A read as an
    undirected graph.  The last round is the one that changed nothing."""
    src, dst = edge_stream(a)
    labels = torch.arange(a.n, dtype=torch.int64, device=src.device)
    rounds = 0
    while True:
        rounds += 1
        new = label_round(labels, src, dst)
        if torch.equal(new, labels):
            return labels, rounds
        labels = new


def component_labels(a: CSC) -> np.ndarray:
    """Component id per node (0 .. n_components - 1, numbered by each
    component's least node), the pattern of the square A read as an
    undirected graph; host numpy."""
    raw, _ = propagate_labels(a)
    _, labels = torch.unique(raw, sorted=True, return_inverse=True)
    return labels.cpu().numpy()


def islands(a: CSC) -> List[np.ndarray]:
    """Sorted node-index arrays (host numpy), one per connected component,
    in the order of their least node."""
    if a.m == 0:
        return []
    labels = component_labels(a)
    order = np.argsort(labels, kind="stable")
    boundaries = np.flatnonzero(np.diff(labels[order])) + 1
    return [np.sort(part) for part in np.split(order, boundaries)]
