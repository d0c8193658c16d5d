"""DataFeedDesc (ref: python/paddle/fluid/data_feed_desc.py).

Describes the MultiSlot text format the Dataset trainer path consumes:
one line per sample, each slot serialized as ``<n> v1 .. vn``. The
reference stores the description as a DataFeedDesc protobuf; here it is
a plain python structure parsed from (and printed back to) the same
text-proto format, so reference ``.proto`` files work unchanged without
a protobuf runtime dependency.
"""

__all__ = ["DataFeedDesc"]


class _Slot:
    __slots__ = ("name", "type", "is_dense", "is_used", "dense_dim")

    def __init__(self, name, type="uint64", is_dense=False, is_used=False):
        self.name = name
        self.type = type
        self.is_dense = is_dense
        self.is_used = is_used
        self.dense_dim = 1


def _parse_text_proto(text):
    """Minimal text-proto reader for the DataFeedDesc schema: top-level
    scalar fields, one ``multi_slot_desc`` block containing repeated
    ``slots`` blocks of scalar fields."""
    import re

    top = {"name": "MultiSlotDataFeed", "batch_size": 32}
    slots = []
    # tokenize: key: value | key { | }
    tokens = re.findall(r'[\w_]+\s*:\s*(?:"[^"]*"|[^\s{}]+)|[\w_]+\s*\{|\}',
                        text)
    stack = []
    cur = None
    for tok in tokens:
        tok = tok.strip()
        if tok.endswith("{"):
            scope = tok[:-1].strip()
            stack.append(scope)
            if scope == "slots":
                cur = {}
            continue
        if tok == "}":
            scope = stack.pop()
            if scope == "slots" and cur is not None:
                s = _Slot(
                    cur.get("name", "slot%d" % len(slots)),
                    cur.get("type", "uint64"),
                    _truthy(cur.get("is_dense", "false")),
                    _truthy(cur.get("is_used", "false")),
                )
                slots.append(s)
                cur = None
            continue
        key, _, val = tok.partition(":")
        key, val = key.strip(), val.strip().strip('"')
        if stack and stack[-1] == "slots":
            cur[key] = val
        elif not stack:
            top[key] = val
    return top, slots


def _truthy(v):
    return str(v).lower() in ("true", "1")


class DataFeedDesc:
    """Parse a text-proto description of the feed (ref data_feed_desc.py:21).

    Accepts either a path to a proto text file (the reference calling
    convention) or the proto text itself (convenience).
    """

    def __init__(self, proto_file):
        import os

        if os.path.exists(proto_file):
            with open(proto_file) as f:
                text = f.read()
        else:
            text = proto_file
        top, slots = _parse_text_proto(text)
        self._name = top.get("name", "MultiSlotDataFeed")
        self._batch_size = int(top.get("batch_size", 32))
        self._slots = slots
        self.__name_to_slot = {s.name: s for s in slots}

    # -- mutators (ref API) --------------------------------------------
    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_dense_slots(self, dense_slots_name):
        """Mark slots dense: batch values become a contiguous (B, n)
        array instead of a ragged LoD slot."""
        for n in dense_slots_name:
            if n not in self.__name_to_slot:
                raise ValueError(
                    "set_dense_slots: unknown slot %r (have %s)"
                    % (n, sorted(self.__name_to_slot))
                )
            self.__name_to_slot[n].is_dense = True

    def set_use_slots(self, use_slots_name):
        for n in use_slots_name:
            if n not in self.__name_to_slot:
                raise ValueError(
                    "set_use_slots: unknown slot %r (have %s)"
                    % (n, sorted(self.__name_to_slot))
                )
            self.__name_to_slot[n].is_used = True

    # -- introspection -------------------------------------------------
    @property
    def slots(self):
        return list(self._slots)

    def used_slots(self):
        return [s for s in self._slots if s.is_used]

    def desc(self):
        """Text-proto form (ref returns the protobuf text dump)."""
        out = ['name: "%s"' % self._name,
               "batch_size: %d" % self._batch_size,
               "multi_slot_desc {"]
        for s in self._slots:
            out.append("  slots {")
            out.append('    name: "%s"' % s.name)
            out.append('    type: "%s"' % s.type)
            out.append("    is_dense: %s" % str(s.is_dense).lower())
            out.append("    is_used: %s" % str(s.is_used).lower())
            out.append("  }")
        out.append("}")
        return "\n".join(out) + "\n"
