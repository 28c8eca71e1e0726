"""Parameter pytrees (nested dicts and lists of tensors) as flat lists, for
autograd and the ``torch._foreach_*`` optimizer arithmetic."""


def leaves(tree) -> list:
    """The leaves in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaf_paths(tree, prefix: str = "") -> list:
    """The key path of every leaf in ``leaves`` order, written as JAX's
    ``keystr`` writes it: ``['layers'][0]['dilated']['w']``."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}[{i}]")]
    return [prefix]


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


def map_with_path(fn, tree, prefix: str = ""):
    """tree_map of fn(path, leaf), the path as ``leaf_paths`` writes it."""
    return unflatten(tree, [fn(p, x) for p, x in zip(leaf_paths(tree, prefix), leaves(tree))])
