"""Nested-structure utilities (ref: python/paddle/fluid/layers/utils.py);
a copy of paddle_tpu/fluid/layers/utils.py.

Generic pytree helpers over list/tuple/namedtuple/dict used by the
cell-based RNN API (rnn, dynamic_decode). Leaves are anything that is not
a sequence/dict (Variables, tensors, dtype strings, shapes-as-Shape...).
"""
import collections

__all__ = []


def is_sequence(seq):
    if isinstance(seq, dict):
        return True
    return isinstance(seq, collections.abc.Sequence) and not isinstance(
        seq, str
    )


def _sorted_keys(d):
    try:
        return sorted(d)
    except TypeError:
        raise TypeError("dict keys in a nested structure must be sortable")


def _yield_flat(nest):
    if isinstance(nest, dict):
        for k in _sorted_keys(nest):
            for leaf in _yield_flat(nest[k]):
                yield leaf
    elif is_sequence(nest):
        for item in nest:
            for leaf in _yield_flat(item):
                yield leaf
    else:
        yield nest


def flatten(nest):
    """Flatten a (possibly nested) structure into a list of leaves; a
    lone leaf becomes a one-element list. Dict leaves are emitted in
    sorted-key order (deterministic program construction)."""
    return list(_yield_flat(nest))


def _pack(structure, flat, index):
    if isinstance(structure, dict):
        out = {}
        for k in _sorted_keys(structure):
            out[k], index = _pack(structure[k], flat, index)
        return type(structure)(out), index
    if is_sequence(structure):
        items = []
        for sub in structure:
            packed, index = _pack(sub, flat, index)
            items.append(packed)
        if isinstance(structure, tuple) and hasattr(structure, "_fields"):
            return type(structure)(*items), index
        return type(structure)(items), index
    return flat[index], index + 1


def pack_sequence_as(structure, flat_sequence):
    """Inverse of flatten: rebuild `structure`'s shape from the leaves in
    `flat_sequence` (namedtuples and dict types preserved)."""
    flat = list(flat_sequence)
    if not is_sequence(structure) and not isinstance(structure, dict):
        if len(flat) != 1:
            raise ValueError(
                "structure is a leaf but flat_sequence has %d items"
                % len(flat))
        return flat[0]
    packed, used = _pack(structure, flat, 0)
    if used != len(flat):
        raise ValueError(
            "flat_sequence has %d leaves, structure expects %d"
            % (len(flat), used))
    return packed


def map_structure(func, *structures):
    """Apply func leaf-wise across parallel structures, rebuilding the
    first structure's shape."""
    flats = [flatten(s) for s in structures]
    n = len(flats[0])
    for f in flats[1:]:
        if len(f) != n:
            raise ValueError("structures have mismatched leaf counts")
    results = [func(*leaves) for leaves in zip(*flats)]
    return pack_sequence_as(structures[0], results)


def assert_same_structure(a, b, check_types=True):
    """Raise ValueError unless a and b have identical nesting."""

    def _walk(x, y):
        xs, ys = is_sequence(x) or isinstance(x, dict), \
            is_sequence(y) or isinstance(y, dict)
        if xs != ys:
            raise ValueError(
                "structures differ: %r vs %r" % (type(x), type(y)))
        if not xs:
            return
        if check_types and type(x) is not type(y):
            raise ValueError(
                "structure types differ: %r vs %r" % (type(x), type(y)))
        if isinstance(x, dict):
            if _sorted_keys(x) != _sorted_keys(y):
                raise ValueError("dict keys differ in nested structure")
            for k in _sorted_keys(x):
                _walk(x[k], y[k])
        else:
            if len(x) != len(y):
                raise ValueError("sequence lengths differ: %d vs %d"
                                 % (len(x), len(y)))
            for xi, yi in zip(x, y):
                _walk(xi, yi)

    _walk(a, b)
