"""Nodes per step of the K-step CUDA graph: the program's counter
``exec.graph_nodes``, every node of the newest captured graph (kernels,
copies, memsets, events) over K. None where no graph was captured (no
card)."""

from h100bench import program


def read(rec):
    found = program.recorded()
    if not found:
        return None
    return found["counters"].get("exec.graph_nodes")
