"""Parameter pytrees (nested dicts and lists of tensors) as flat lists, for
autograd and the ``torch._foreach_*`` optimizer arithmetic."""


def leaves(tree) -> list:
    """The leaves in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, flat):
    """A tree shaped as ``like`` with the leaves of ``flat`` (in ``leaves``
    order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def tree_map(fn, tree):
    return unflatten(tree, [fn(x) for x in leaves(tree)])
