"""The one tolerant JSONL/JSON reader (pure stdlib; port of
paddle_tpu/integrity/jsonl.py).

Three hand-rolled copies of "skip the torn final line and keep going"
used to live in ``DecisionJournal.read_jsonl``,
``observability.distributed.read_spans``, and the elastic FileStore's
doc scan. They now share this reader, which also *counts* what it
skipped — a dropped record is a data-integrity signal, not something
to swallow silently.

Deliberately import-free of the rest of paddle_tpu_torch: observability
imports this module, so it must never import observability back.
"""
import json


def parse_lines(lines):
    """Parse an iterable of JSONL lines -> ``(records, dropped)``.

    Blank lines are skipped without counting (a trailing newline is
    not corruption); unparseable lines — torn final line of an
    append-only log, a partial write racing the reader — are skipped
    and counted in ``dropped``.
    """
    records, dropped = [], 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            dropped += 1
    return records, dropped


def read_jsonl(path):
    """Tolerantly read a JSONL file -> ``(records, dropped)``.

    A missing/unreadable file is ``([], 0)`` — absence is not
    corruption.
    """
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return parse_lines(f)
    except OSError:
        return [], 0


def read_json_doc(path):
    """Tolerantly read one JSON doc -> ``(doc_or_None, dropped)``.

    ``dropped`` is 1 when the file existed but did not parse (torn
    write, concurrent replace) and 0 otherwise; a missing file is
    ``(None, 0)``.
    """
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return json.load(f), 0
    except OSError:
        return None, 0
    except ValueError:
        return None, 1
