"""Derivation-tree visualization (a copy of
evostencils_tpu/utils/visualization.py; reference
optimization/program.py:935-946).

Produces Graphviz DOT text for any grammar tree; rendering to PNG is
attempted via pygraphviz/graphviz when available and silently skipped in
minimal environments (without graphviz)."""

from __future__ import annotations

from typing import List, Tuple


def tree_to_graph(individual) -> Tuple[List[int], List[Tuple[int, int]], dict]:
    """(nodes, edges, labels) of the prefix-order tree."""
    nodes = list(range(len(individual)))
    labels = {i: node.name for i, node in enumerate(individual)}
    edges = []
    stack: List[Tuple[int, int]] = []  # (node index, remaining children)
    for i, node in enumerate(individual):
        if stack:
            parent, remaining = stack[-1]
            edges.append((parent, i))
            if remaining == 1:
                stack.pop()
            else:
                stack[-1] = (parent, remaining - 1)
        if node.arity > 0:
            stack.append((i, node.arity))
    return nodes, edges, labels


def to_dot(individual, name: str = "derivation") -> str:
    nodes, edges, labels = tree_to_graph(individual)
    lines = [f"digraph {name} {{", "  node [shape=box, fontsize=10];"]
    for i in nodes:
        label = labels[i].replace('"', "'")
        lines.append(f'  n{i} [label="{label}"];')
    for a, b in edges:
        lines.append(f"  n{a} -> n{b};")
    lines.append("}")
    return "\n".join(lines)


def draw_tree(individual, filename: str) -> str:
    """Write DOT (always) and attempt a PNG render (best effort).

    Returns the path of the DOT file."""
    dot_path = f"{filename}.dot"
    with open(dot_path, "w") as f:
        f.write(to_dot(individual))
    try:
        import pygraphviz as pgv

        g = pgv.AGraph(string=to_dot(individual))
        g.layout(prog="dot")
        g.draw(f"{filename}.png", "png")
    except Exception:
        pass
    return dot_path
