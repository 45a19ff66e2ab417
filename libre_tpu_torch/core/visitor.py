"""Octree depth-first traversal with visitor control flags.

Reference: livre/core/visitor/{DFSTraversal,NodeVisitor,VisitState}.
Traversal starts from every root block and descends while the visitor keeps
``visit_child`` set; ``break_traversal`` aborts the walk.
"""

from __future__ import annotations

from libre_tpu_torch.core.nodeid import NodeId, RootNode


class VisitState:
    """Traversal control flags (livre/core/visitor/VisitState.h)."""

    __slots__ = ("visit_child", "visit_neighbours", "break_traversal")

    def __init__(self):
        self.visit_child = True
        self.visit_neighbours = True
        self.break_traversal = False


class NodeVisitor:
    """Visitor base (livre/core/visitor/NodeVisitor.h)."""

    def visit_pre(self) -> None:
        pass

    def visit(self, node_id: NodeId, state: VisitState) -> None:
        raise NotImplementedError

    def visit_post(self) -> None:
        pass


def _traverse(node_id: NodeId, depth: int, visitor: NodeVisitor) -> bool:
    """Recursive DFS matching DFSTraversal.cpp:33-67 (fresh state per node)."""
    if depth == 0:
        return False

    state = VisitState()
    visitor.visit(node_id, state)

    if state.break_traversal:
        return True
    if not state.visit_child:
        return False

    for child in node_id.children():
        if _traverse(child, depth - 1, visitor):
            return True
        if not state.visit_neighbours:
            break
    return False


def dfs_traverse(root_node: RootNode, visitor: NodeVisitor, time_step: int = 0) -> None:
    """Traverse all root blocks in x-major, z-minor order
    (DFSTraversal.cpp:91-104)."""
    visitor.visit_pre()
    for node_id in root_node.iter_roots(time_step):
        _traverse(node_id, root_node.depth, visitor)
    visitor.visit_post()
