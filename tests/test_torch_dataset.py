"""The port's host data path against the JAX package, on the CPU.

- The MultiSlot parser gives the reference's samples and raises on the
  same malformed lines; ``local_shuffle`` keeps the reference's seeded
  order; ``QueueDataset`` streams every sample once; ``DataFeedDesc``
  reads back the dataset's description; a ``MultiSlotDataGenerator``
  writes what the dataset parses.
- ``Executor.train_from_dataset`` on Wide&Deep (vocab 1000, hidden
  [32, 32]) is bit-identical to a ``run`` loop over the dataset's batches,
  through the native pipe and through the Python fallback alike.
- One epoch of ``train_from_dataset`` against the JAX package's on the
  same shard files (``set_thread(1)``: with more parser threads the sample
  order is the order the threads finish in) from the same JAX-initialised
  parameters, 6 Adam steps: each parameter's update (after - before)
  within 1e-2 of its largest update element by element. Adam scales each
  element's step by that element's own gradient history, so an element
  whose gradients are rounding noise takes a step of up to the learning
  rate in the direction the noise gives it: measured 2.7e-3 of the
  largest update in ``ctr_emb`` (2 of 16,000 elements more than 1e-7
  apart), 1e-4 or less elsewhere. A wrong step size, bias correction or
  sample order moves whole parameters. The JAX package scans 8 steps a
  dispatch, the port runs them one by one (the same numbers either way).
- ``infer_from_dataset`` leaves every trainable parameter bit-identical
  and still moves ``auc``'s statistics.
- ``DataLoader.from_generator`` feeds ``Executor.run``; the native library
  builds into ``paddle_tpu_torch/_build/`` and the loader reports which
  pipeline ran.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.models import wide_deep as jwd
import paddle_tpu_torch
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.data_feeder import DataFeeder
from paddle_tpu_torch.fluid.incubate.data_generator import (
    MultiSlotDataGenerator)
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import wide_deep as wd
from paddle_tpu_torch.native import build as native_build
from paddle_tpu_torch.native import pipeline as native_pipeline

VOCAB = 1000
SMALL = dict(sparse_vocab=VOCAB, hidden=[32, 32])
UPDATE_TOL = 1e-2


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, name generator and scope of the port."""
    old_main = pt_framework.switch_main_program(pt_framework.Program())
    old_startup = pt_framework.switch_startup_program(pt_framework.Program())
    old_gen = pt_unique_name.switch()
    old_scopes = pt_executor._scope_stack[:]
    pt_executor._scope_stack[:] = [pt_executor.Scope()]
    yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)
    pt_executor._scope_stack[:] = old_scopes


def write_shards(dirname, shards=2, rows=96, seed=0):
    """Criteo-shaped MultiSlot shards as bench.py writes them (13 dense,
    26 sparse ids, 1 label; slot order dense, sparse, label), ids below
    VOCAB."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(1).standard_normal(13)
    files = []
    for s in range(shards):
        path = os.path.join(str(dirname), "part_%d.txt" % s)
        with open(path, "w") as f:
            for _ in range(rows):
                sparse = rng.integers(0, VOCAB, size=26)
                dense = rng.standard_normal(13)
                f.write("13 %s 26 %s 1 %d\n" % (
                    " ".join("%.4f" % x for x in dense),
                    " ".join(map(str, sparse)), int(dense @ w > 0)))
        files.append(path)
    return files


def _build(fl, un, pkg):
    un.switch()
    main, start = fl.Program(), fl.Program()
    start.random_seed = 7
    with fl.program_guard(main, start):
        vs = pkg.build_wide_deep(**SMALL)
        fl.optimizer.Adam(1e-3).minimize(vs["loss"])
    return main, start, vs


def _dataset(fl, vs, files, kind="InMemoryDataset", batch=32, thread=1):
    ds = fl.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_thread(thread)
    ds.set_filelist(files)
    ds.set_use_var([vs["dense"], vs["sparse"], vs["label"]])
    if kind == "InMemoryDataset":
        ds.load_into_memory()
    return ds


def _jax_init():
    """The JAX package's program, executor and scope after startup, and
    its persistables as numpy."""
    jmain, jstart, jvs = _build(jfluid, jax_unique_name, jwd)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    state = {v.name: np.array(jscope[v.name])
             for v in jstart.global_block().vars.values() if v.persistable}
    return (jmain, jexe, jscope, jvs), state


def _port_scope(state):
    scope = fluid.Scope()
    for n, t in params_from_numpy(state, torch.device("cpu")).items():
        scope.set(n, t)
    return scope


def _persistables(main, scope):
    return {v.name: scope[v.name].numpy()
            for v in main.global_block().vars.values()
            if v.persistable and v.name in scope}


# ---------------------------------------------------------------------------
# parsing, shuffling, streaming
# ---------------------------------------------------------------------------
def test_multislot_parser_matches_the_reference(tmp_path):
    files = write_shards(tmp_path, shards=1, rows=5)
    _, _, pvs = _build(fluid, pt_unique_name, wd)
    _, _, jvs = _build(jfluid, jax_unique_name, jwd)
    ds, jds = _dataset(fluid, pvs, files), _dataset(jfluid, jvs, files)
    try:
        assert len(ds._memory) == 5
        for a, w in zip(ds._memory, jds._memory):
            assert a == w
        sample = ds._memory[0]
        assert len(sample[0]) == 13 and len(sample[1]) == 26
        assert all(isinstance(v, int) for v in sample[1] + sample[2])
        spec = ds._slot_spec()
        assert spec == [(False, 13), (True, 26), (True, 1)]
        with pytest.raises(ValueError, match="line ended before slot 2"):
            ds._parse_line("1 0.5 1 3", [(False, 1)] * 3)
        with pytest.raises(ValueError, match="declares 3 values, found 2"):
            ds._parse_line("3 1 2", [(True, None)])
        with pytest.raises(ValueError, match="expects 13 values"):
            ds._parse_line("2 0.1 0.2 26 %s 1 0" % " ".join(["1"] * 26),
                           spec)
        assert ds._parse_line("   \n", spec) is None
    finally:
        ds.release_memory()


def test_local_shuffle_keeps_the_reference_order(tmp_path):
    files = write_shards(tmp_path, shards=2, rows=40)
    _, _, pvs = _build(fluid, pt_unique_name, wd)
    _, _, jvs = _build(jfluid, jax_unique_name, jwd)
    ds, jds = _dataset(fluid, pvs, files), _dataset(jfluid, jvs, files)
    before = list(ds._memory)
    for _ in range(2):                  # the seed advances per shuffle
        ds.local_shuffle()
        jds.local_shuffle()
        assert ds._memory == jds._memory
    assert ds._memory != before and sorted(ds._memory) == sorted(before)
    # the columnar fast path follows the shuffle
    cols = ds._try_columnarize()
    np.testing.assert_array_equal(cols[1][0], ds._memory[0][1])
    assert ds.get_memory_data_size() == 80
    ds.release_memory()


@pytest.mark.parametrize("thread", [1, 2])
def test_queue_dataset_streams_every_sample_once(tmp_path, thread):
    files = write_shards(tmp_path, shards=2, rows=20)
    _, _, pvs = _build(fluid, pt_unique_name, wd)
    mem = _dataset(fluid, pvs, files)
    q = _dataset(fluid, pvs, files, kind="QueueDataset", batch=8,
                 thread=thread)
    batches = list(q._batch_iterator())
    got = [s for b in batches for s in b]
    assert sorted(got) == sorted(mem._memory)
    if thread == 1:                     # one parser: file order, 8 a batch
        assert got == mem._memory
        assert [len(b) for b in batches] == [8, 8, 8, 8, 8]
    with pytest.raises(NotImplementedError):
        q.local_shuffle()
    mem.release_memory()


def test_dataset_factory_and_desc():
    _, _, pvs = _build(fluid, pt_unique_name, wd)
    with pytest.raises(ValueError, match="unknown dataset class"):
        fluid.DatasetFactory().create_dataset("NoSuchDataset")
    with pytest.raises(NotImplementedError, match="BoxPS"):
        fluid.dataset.BoxPSDataset()
    ds = fluid.DatasetFactory().create_dataset("FileInstantDataset")
    ds.set_use_var([pvs["dense"], pvs["sparse"], pvs["label"]])
    ds.set_batch_size(64)
    desc = fluid.DataFeedDesc(ds.desc())
    assert [s.name for s in desc.slots] == ["dense", "sparse", "ctr_label"]
    assert [s.is_dense for s in desc.slots] == [True, True, True]
    assert 'type: "float"' in ds.desc() and "batch_size: 64" in ds.desc()


def test_lod_feed_waits_for_the_sequence_slice():
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        ids = fluid.data("ids", [-1, 1], dtype="int64", lod_level=1)
    with pytest.raises(NotImplementedError, match="item 6.5"):
        DataFeeder([ids], fluid.CPUPlace()).feed([([1, 2],), ([3],)])


class _Gen(MultiSlotDataGenerator):
    def generate_sample(self, line):
        def it():
            rng = np.random.default_rng(5)
            for _ in range(12):
                yield [("dense", [round(float(x), 4)
                                  for x in rng.random(13)]),
                       ("sparse", rng.integers(0, VOCAB, 26).tolist()),
                       ("ctr_label", [int(rng.integers(0, 2))])]
        return it


def test_data_generator_writes_what_the_dataset_parses(tmp_path):
    path = str(tmp_path / "gen.txt")
    with open(path, "w") as f:
        _Gen().run_from_memory(out=f)
    _, _, pvs = _build(fluid, pt_unique_name, wd)
    ds = _dataset(fluid, pvs, [path])
    assert len(ds._memory) == 12
    assert len(ds._memory[0][0]) == 13 and len(ds._memory[0][1]) == 26
    ds.release_memory()


# ---------------------------------------------------------------------------
# train_from_dataset / infer_from_dataset
# ---------------------------------------------------------------------------
def _run_loop(exe, main, vs, ds, scope):
    """The dataset's batches fed one by one through Executor.run."""
    feeder = DataFeeder([vs["dense"], vs["sparse"], vs["label"]],
                        fluid.CPUPlace())
    for batch in ds._batch_iterator():
        exe.run(main, feed=feeder.feed(batch), scope=scope)


@pytest.mark.parametrize("pipe", ["native", "python"])
def test_train_from_dataset_equals_a_run_loop(tmp_path, monkeypatch, pipe):
    if pipe == "python":
        # the native library does not load: the loader falls back
        monkeypatch.setattr(native_build, "load_native", lambda: None)
    files = write_shards(tmp_path, shards=2, rows=80)
    (_, _, _, _), state = _jax_init()
    pmain, _, pvs = _build(fluid, pt_unique_name, wd)
    ds = _dataset(fluid, pvs, files)
    ds.local_shuffle()
    try:
        a, b = _port_scope(state), _port_scope(state)
        fluid.Executor(fluid.CPUPlace()).train_from_dataset(
            pmain, ds, scope=a)
        assert ds._loader_cache[1].pipeline == pipe
        _run_loop(fluid.Executor(fluid.CPUPlace()), pmain, pvs, ds, b)
        pa, pb = _persistables(pmain, a), _persistables(pmain, b)
        assert sorted(pa) == sorted(pb)
        for n in pa:
            np.testing.assert_array_equal(pa[n], pb[n], err_msg=n)
        # the parameters moved: 5 batches, the last one partial
        assert not np.array_equal(pa["deep_fc0.w"], state["deep_fc0.w"])
        assert pa["auc_0.w_0"].sum() + pa["auc_0.w_1"].sum() == 160
    finally:
        ds.release_memory()


def test_train_from_dataset_matches_jax(tmp_path):
    files = write_shards(tmp_path, shards=2, rows=96)
    (jmain, jexe, jscope, jvs), state = _jax_init()
    pmain, _, pvs = _build(fluid, pt_unique_name, wd)
    ds, jds = _dataset(fluid, pvs, files), _dataset(jfluid, jvs, files)
    try:
        scope = _port_scope(state)
        fluid.Executor(fluid.CPUPlace()).train_from_dataset(
            pmain, ds, scope=scope)
        jexe.train_from_dataset(jmain, jds, scope=jscope)
        for p in pmain.all_parameters():
            if not p.trainable:
                continue
            a, w = scope[p.name].numpy(), np.asarray(jscope[p.name])
            du, dw = a - state[p.name], w - state[p.name]
            assert float(np.abs(dw).max()) > 0, p.name
            assert float(np.abs(du - dw).max()) <= UPDATE_TOL * float(
                np.abs(dw).max()), p.name
        for n in ("auc_0.w_0", "auc_0.w_1"):
            a, w = scope[n].numpy(), np.asarray(jscope[n])
            assert a.sum() == w.sum()
            assert np.abs(np.cumsum(a - w)).max() <= 1
    finally:
        ds.release_memory()
        jds.release_memory()


def test_infer_from_dataset_leaves_the_parameters(tmp_path, capsys):
    files = write_shards(tmp_path, shards=1, rows=64)
    (_, _, _, _), state = _jax_init()
    pmain, _, pvs = _build(fluid, pt_unique_name, wd)
    ds = _dataset(fluid, pvs, files)
    try:
        scope = _port_scope(state)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.infer_from_dataset(pmain, ds, scope=scope,
                               fetch_list=[pvs["auc"]], fetch_info=["auc"],
                               print_period=1)
        for p in pmain.all_parameters():
            got = scope[p.name].numpy()
            if p.trainable:
                np.testing.assert_array_equal(got, state[p.name],
                                              err_msg=p.name)
        stats = scope["auc_0.w_0"].numpy() + scope["auc_0.w_1"].numpy()
        assert stats.sum() == 64
        out = capsys.readouterr().out
        assert "[dataset step 2] auc=" in out
        # the training program itself is unchanged, and trains after
        assert any(op.type == "backward" for op in pmain.global_block().ops)
        exe.train_from_dataset(pmain, ds, scope=scope)
        assert not np.array_equal(scope["head.w"].numpy(), state["head.w"])
    finally:
        ds.release_memory()


def test_loader_is_reused_across_epochs(tmp_path):
    files = write_shards(tmp_path, shards=1, rows=40)
    pmain, pstart, pvs = _build(fluid, pt_unique_name, wd)
    ds = _dataset(fluid, pvs, files)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(pstart, scope=scope)
    exe.train_from_dataset(pmain, ds, scope=scope)
    first = ds._loader_cache[1]
    exe.train_from_dataset(pmain, ds, scope=scope)
    assert ds._loader_cache[1] is first
    ds.release_memory()
    assert ds._loader_cache is None and first._pipe is None


# ---------------------------------------------------------------------------
# DataLoader and the native pipe
# ---------------------------------------------------------------------------
def test_dataloader_from_generator_feeds_run():
    pmain, pstart, pvs = _build(fluid, pt_unique_name, wd)
    exe = fluid.Executor(fluid.CPUPlace())
    a, b = fluid.Scope(), fluid.Scope()
    exe.run(pstart, scope=a)
    for n, t in a.items():
        b.set(n, t.clone())
    batches = [wd.synthetic_ctr_batch(16, sparse_vocab=VOCAB, seed=s)
               for s in range(3)]
    loader = fluid.DataLoader.from_generator(
        feed_list=[pvs["dense"], pvs["sparse"], pvs["label"]], capacity=4)
    loader.set_batch_generator(lambda: iter(batches),
                               places=fluid.CPUPlace())
    got = [exe.run(pmain, feed=feed, fetch_list=[pvs["loss"]], scope=a)[0]
           for feed in loader()]
    want = [exe.run(pmain, feed={"dense": d, "sparse": s, "ctr_label": lab},
                    fetch_list=[pvs["loss"]], scope=b)[0]
            for d, s, lab in batches]
    np.testing.assert_array_equal(np.array(got), np.array(want))
    assert loader.pipeline in ("native", "python")
    if loader._pipe is not None:
        loader._pipe.close()


def test_native_library_builds_into_the_build_dir():
    lib = native_build.load_native()
    assert lib is not None, native_build.load_error
    pkg = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
    path = native_build.library_path()
    assert os.path.dirname(path) == os.path.join(pkg, "_build")
    assert os.path.exists(path)
    assert not [f for f in os.listdir(os.path.join(pkg, "native"))
                if f.endswith(".so")]
    pipe = native_pipeline.NativeBatchPipe(capacity=2, slot_bytes=1 << 16)
    try:
        batch = {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
                 "ids": np.arange(5, dtype=np.int64)}
        assert pipe.put(batch)
        out, release = pipe.get()
        for k, v in batch.items():
            np.testing.assert_array_equal(out[k], v)
        release()
        assert pipe.put_error("boom")
        with pytest.raises(RuntimeError, match="boom"):
            pipe.get()
    finally:
        pipe.close()
