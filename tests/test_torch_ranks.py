"""The multi-rank test helper (tests/torch_ranks.py) ends its ranks
cleanly: a rank that is done with its groups before its peers must not
tear them down under them.

Each case spawns 4 gloo ranks that make a ``new_group`` over part of
the world and return at once (``torch_ranks.leave_at_once``): rank 0,
outside the shrunk group, finishes first. Before the helper waited for
every rank before teardown, such a spawn failed now and then (a peer's
``new_group`` got "Connection closed by peer", or a rank aborted in
teardown with exit -6); ``run_ranks`` refuses any rank that exits with
another code than 0.
"""
import pytest

import torch_ranks as tr


@pytest.mark.parametrize("attempt", range(3))
def test_ranks_that_leave_a_subgroup_at_once_exit_cleanly(tmp_path,
                                                          attempt):
    got = tr.run_ranks(tr.leave_at_once, 4, tmp_path, timeout=60)
    assert got == [(None, None), (0, 0), (None, 1), (1, 2)]
