"""The port's copies of the JAX package's jax-free modules, against the
originals, on the CPU.

- ``compat``, ``batch``, ``fluid.average.WeightedAverage``,
  ``fluid.default_scope_funcs`` (over the port's ``Scope``),
  ``sysconfig`` and ``check_import_scipy`` give what the JAX package's
  give.
- ``fluid.op``: ``get_all_op_protos`` lists the port's 305 registered
  types, each one the JAX package registers too; the constructors raise
  as the reference's do.
- The first samples of every ``dataset/`` reader, and the ``utils``
  functions on seeded numpy inputs, equal the JAX package's.
- Walking ``paddle_tpu_torch`` (as ``test_port_imports_no_jax`` does)
  reaches every module these copies and this slice add.
"""
import importlib
import io
import itertools
import pkgutil
import warnings

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name

N_SAMPLES = 3


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


def _mod(pkg, name):
    return importlib.import_module("%s.%s" % (pkg.__name__, name))


def _plain(v):
    """A value both packages can be compared by: arrays as (dtype, shape,
    bytes), objects by class name and attributes, containers item by
    item."""
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, np.generic):
        return ("scalar", str(v.dtype), v.item())
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_plain(x) for x in v])
    if hasattr(v, "__dict__") and not callable(v):
        return (type(v).__name__, _plain(vars(v)))
    return v


def _both(fn):
    """fn(package) for the JAX package and the port, numpy's global
    generator seeded alike before each."""
    out = []
    for pkg in (paddle_tpu, paddle_tpu_torch):
        np.random.seed(11)
        out.append(_plain(fn(pkg)))
    return out


# ---------------------------------------------------------------------------
# small modules
# ---------------------------------------------------------------------------
SMALL = {
    "compat": lambda p: [
        p.compat.to_text([b"ab", "c"]), p.compat.to_bytes({"x"}),
        p.compat.round(2.5), p.compat.round(-2.345, 2),
        p.compat.floor_division(7, 2),
        p.compat.get_exception_message(ValueError("boom")),
        p.compat.long_type(3)],
    "batch": lambda p: list(p.batch(lambda: iter(range(7)), 3)()),
    "batch_drop_last": lambda p: list(p.batch(lambda: iter(range(7)), 3,
                                              drop_last=True)()),
    "weighted_average": lambda p: _average(p),
    "default_scope_funcs": lambda p: _scope_funcs(p),
    "sysconfig": lambda p: [p.sysconfig.get_include().split("/")[-1],
                            p.sysconfig.get_lib().split("/")[-1]],
    "check_import_scipy": lambda p: [
        _mod(p, "check_import_scipy").check_import_scipy("posix")],
    "annotations": lambda p: _deprecated(p),
    "wrapped_decorator": lambda p: _wrapped(p),
    "log_helper": lambda p: _logger(p),
    "layer_function_generator": lambda p: _generator_docs(p),
    "device_get_places": lambda p: [
        type(pl).__name__ for pl in
        p.fluid.layers.device.get_places(2, "CPU")],
}


def _generator_docs(p):
    g = _mod(p.fluid.layers, "layer_function_generator")

    @g.templatedoc("relu")
    def f(x):
        """${comment}; x: ${x_comment} (${x_type})."""

    @g.autodoc("Autodoc. ")
    def h():
        """Body."""

    g.add_sample_code(h, " Example.")
    return [f.__doc__, h.__doc__, sorted(g.__all__)]


def _average(p):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        avg = p.fluid.average.WeightedAverage()
    avg.add(np.array([1.0, 2.0]), 2)
    avg.add(np.array([4.0, 1.0]), 1)
    scalar = p.fluid.average.WeightedAverage.__new__(
        p.fluid.average.WeightedAverage)
    scalar.reset()
    scalar.add(3, 0.5)
    scalar.add(1.0, 1.5)
    return [avg.eval(), scalar.eval()]


def _scope_funcs(p):
    f = p.fluid.default_scope_funcs
    outer = f.get_cur_scope()
    outer.set("w", np.arange(3.0))
    f.enter_local_scope()
    inner = f.get_cur_scope()
    got = [inner is not outer, f.find_var("w") is not None,
           np.asarray(f.find_var("w")).tolist(), f.find_var("nope")]
    f.var("v").set(np.ones(2))
    got.append(np.asarray(inner.find_var("v")).tolist())
    f.leave_local_scope()
    got += [f.get_cur_scope() is outer, outer.find_var("v")]
    seen = []
    f.scoped_function(lambda: seen.append(f.get_cur_scope() is not outer))
    return got + seen


def _deprecated(p):
    @p.fluid.annotations.deprecated("1.0", "new_api")
    def old(x):
        """Old."""
        return x + 1

    import contextlib
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = old(1)
    return [out, err.getvalue(), old.__doc__, old.__name__]


def _wrapped(p):
    @p.fluid.wrapped_decorator.signature_safe_contextmanager
    def ctx(v):
        """Yields v."""
        yield v * 2

    with ctx(4) as got:
        pass
    return [got, ctx.__name__, ctx.__doc__]


def _logger(p):
    log = p.fluid.log_helper.get_logger("copy_test_%s" % p.__name__, 20,
                                        fmt="%(message)s")
    return [log.level, log.propagate, len(log.handlers)]


@pytest.mark.parametrize("case", sorted(SMALL))
def test_small_modules(case):
    jax_side, port_side = _both(SMALL[case])
    assert port_side == jax_side


def test_op_protos_over_the_port_registry():
    from paddle_tpu.fluid import op as jop
    from paddle_tpu_torch.fluid import op as pop
    from paddle_tpu_torch.ops.registry import LOWERINGS

    types = [o.type for o in pop.get_all_op_protos()]
    assert len(types) == len(LOWERINGS) == 324 and types == sorted(types)
    assert set(types) <= {o.type for o in jop.get_all_op_protos()}
    assert pop.Operator.types() == types
    assert pop.Operator.get_op_info("mul").type == "mul"
    for mod in (jop, pop):
        with pytest.raises(ValueError, match="has not been registered"):
            mod.Operator.get_op_info("no_such_op")
        with pytest.raises(NotImplementedError, match="fluid.layers"):
            mod.Operator("mul", X="x", Y="y", Out="out")
        with pytest.raises(NotImplementedError, match="OpDescCreationMethod"):
            mod.OpDescCreationMethod(mod.get_all_op_protos()[0])()


# ---------------------------------------------------------------------------
# dataset readers: the first samples of each
# ---------------------------------------------------------------------------
DATASETS = {
    "mnist.train": lambda d: d.mnist.train(),
    "mnist.test": lambda d: d.mnist.test(),
    "uci_housing.train": lambda d: d.uci_housing.train(),
    "uci_housing.test": lambda d: d.uci_housing.test(),
    "imdb.train": lambda d: d.imdb.train(d.imdb.word_dict()),
    "imdb.test": lambda d: d.imdb.test(d.imdb.word_dict()),
    "cifar.train10": lambda d: d.cifar.train10(),
    "cifar.test100": lambda d: d.cifar.test100(),
    "imikolov.train": lambda d: d.imikolov.train(d.imikolov.build_dict(), 5),
    "imikolov.test_seq": lambda d: d.imikolov.test(
        d.imikolov.build_dict(), 5, d.imikolov.Seq),
    "movielens.train": lambda d: d.movielens.train(),
    "movielens.test": lambda d: d.movielens.test(),
    "wmt16.train": lambda d: d.wmt16.train(100, 120),
    "wmt16.validation": lambda d: d.wmt16.validation(100, 120, "de"),
    "wmt14.train": lambda d: d.wmt14.train(80),
    "wmt14.gen": lambda d: d.wmt14.gen(80),
    "voc2012.train": lambda d: d.voc2012.train(),
    "voc2012.val": lambda d: d.voc2012.val(),
    "mq2007.train": lambda d: d.mq2007.train(),
    "mq2007.test_listwise": lambda d: d.mq2007.test(format="listwise"),
    "sentiment.train": lambda d: d.sentiment.train(),
    "conll05.test": lambda d: d.conll05.test(),
    "flowers.train": lambda d: d.flowers.train(),
    "flowers.valid_xmap": lambda d: d.flowers.valid(use_xmap=True),
}


@pytest.mark.parametrize("case", sorted(DATASETS))
def test_dataset_first_samples(case):
    jax_side, port_side = _both(lambda p: list(itertools.islice(
        DATASETS[case](p.dataset)(), N_SAMPLES)))
    assert len(port_side[1]) == N_SAMPLES
    assert port_side == jax_side


DATASET_TABLES = {
    "movielens": lambda d: [d.movielens.max_user_id(),
                            d.movielens.max_movie_id(),
                            d.movielens.max_job_id(),
                            d.movielens.movie_categories(),
                            sorted(d.movielens.get_movie_title_dict())[:5]],
    "conll05": lambda d: [len(x) for x in d.conll05.get_dict()]
                         + [d.conll05.get_embedding()],
    "wmt14_dict": lambda d: [sorted(x.items())[:5]
                             for x in d.wmt14.get_dict(80)],
    "wmt16_dict": lambda d: sorted(d.wmt16.get_dict("de", 50).items())[:5],
    "sentiment_dict": lambda d: sorted(d.sentiment.get_word_dict())[:5],
    "image": lambda d: _image_ops(d.image),
    "common_split": lambda d: _common_split(d.common),
}


def _image_ops(image):
    rng = np.random.RandomState(5)
    im = rng.randint(0, 255, (40, 60, 3)).astype(np.uint8)
    small = image.resize_short(im, 24)
    return [small, image.to_chw(small), image.center_crop(small, 16),
            image.left_right_flip(small),
            image.simple_transform(im, 32, 24, False, mean=[1.0, 2.0, 3.0]),
            image.random_crop(small, 16)]


def _common_split(common):
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            common.split(lambda: iter(range(7)), 3)
            files = sorted(os.listdir(tmp))
            got = list(common.cluster_files_reader(
                os.path.join(tmp, "*.pickle"), 2, 0)())
        finally:
            os.chdir(cwd)
    return [files, got, common.md5file.__name__]


@pytest.mark.parametrize("case", sorted(DATASET_TABLES))
def test_dataset_tables(case):
    jax_side, port_side = _both(lambda p: DATASET_TABLES[case](p.dataset))
    assert port_side == jax_side


def test_download_resolves_only_staged_files(tmp_path, monkeypatch):
    """``download`` returns a file already on disk under DATA_HOME and
    raises, fetching nothing, for one that is not, as the JAX package's."""
    got = []
    for pkg in (paddle_tpu, paddle_tpu_torch):
        common = pkg.dataset.common
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
        (tmp_path / "mod").mkdir(exist_ok=True)
        (tmp_path / "mod" / "f.bin").write_bytes(b"x")
        path = common.download("http://example.invalid/f.bin", "mod", None)
        with pytest.raises(Exception) as info:
            common.download("http://example.invalid/g.bin", "mod", None)
        got.append((path, type(info.value).__name__))
    assert got[0] == got[1]
    assert got[1][0] == str(tmp_path / "mod" / "f.bin")


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------
def _rgb(seed, h=20, w=24):
    return np.random.RandomState(seed).randint(
        0, 255, (h, w, 3)).astype(np.float32)


UTILS = {
    "flip": lambda u: u.image_util.flip(_rgb(0).transpose(2, 0, 1)),
    "crop_center": lambda u: u.image_util.crop_img(
        _rgb(1).transpose(2, 0, 1), 16, color=True, test=True),
    "crop_random": lambda u: u.image_util.crop_img(
        _rgb(2).transpose(2, 0, 1), 16, color=True, test=False),
    "crop_pad_gray": lambda u: u.image_util.crop_img(
        _rgb(3, 10, 12)[..., 0], 16, color=False, test=True),
    "preprocess_img": lambda u: u.image_util.preprocess_img(
        _rgb(4).transpose(2, 0, 1), 1.5, 16, True),
    "oversample": lambda u: u.image_util.oversample(
        [_rgb(5), _rgb(6)], (12, 14)),
    "transformer": lambda u: u.image_util.ImageTransformer(
        transpose=(2, 0, 1), channel_swap=(2, 1, 0),
        mean=[1.0, 2.0, 3.0]).transformer(_rgb(7)),
    "ploter": lambda u: _ploter(u),
    "plotcurve_series": lambda u: u.plotcurve._series(
        ["AvgCost", "acc"], ["Pass 0, Batch 1, AvgCost=0.5, acc:0.25",
                             "Test AvgCost=0.4", "Pass 1 AvgCost=1e-2"]),
    "preprocess_util": lambda u: [
        u.preprocess_util.exclude_pattern("a/.b"),
        u.preprocess_util.exclude_pattern("a/b.jpg"),
        u.preprocess_util.Label(1, "cat").__dict__],
    "legacy_raises": lambda u: [_raises(u.show_pb.show_pb, "m.pb"),
                                _raises(u.torch2paddle.main)],
}


def _ploter(u):
    import os

    os.environ["DISABLE_PLOT"] = "True"
    try:
        p = u.Ploter("train", "test")
        p.append("train", 1, 0.5)
        p.append("test", 1, 0.7)
        p.append("train", 2, 0.25)
        data = {k: (v.step, v.value) for k, v in p.__plot_data__.items()}
        p.plot()
        p.reset()
        return [data, {k: (v.step, v.value)
                       for k, v in p.__plot_data__.items()}]
    finally:
        del os.environ["DISABLE_PLOT"]


def _raises(fn, *args):
    with pytest.raises(NotImplementedError) as info:
        fn(*args)
    return type(info.value).__name__


@pytest.mark.parametrize("case", sorted(UTILS))
def test_utils(case):
    jax_side, port_side = _both(lambda p: UTILS[case](p.utils))
    assert port_side == jax_side


# ---------------------------------------------------------------------------
# the import guard reaches the new modules
# ---------------------------------------------------------------------------
NEW_MODULES = [
    "paddle_tpu_torch.batch", "paddle_tpu_torch.compat",
    "paddle_tpu_torch.sysconfig", "paddle_tpu_torch.check_import_scipy",
    "paddle_tpu_torch.dataset", "paddle_tpu_torch.utils",
    "paddle_tpu_torch.fluid.async_pipeline",
    "paddle_tpu_torch.fluid.profiler", "paddle_tpu_torch.fluid.op",
    "paddle_tpu_torch.fluid.average", "paddle_tpu_torch.fluid.annotations",
    "paddle_tpu_torch.fluid.wrapped_decorator",
    "paddle_tpu_torch.fluid.default_scope_funcs",
    "paddle_tpu_torch.fluid.log_helper",
    "paddle_tpu_torch.fluid.layer_helper_base",
    "paddle_tpu_torch.fluid.layers.math_op_patch",
    "paddle_tpu_torch.fluid.layers.distributions",
    "paddle_tpu_torch.fluid.layers.device",
    "paddle_tpu_torch.fluid.layers.layer_function_generator",
] + ["paddle_tpu_torch.dataset." + m for m in (
    "common", "mnist", "uci_housing", "imdb", "cifar", "imikolov",
    "movielens", "wmt16", "wmt14", "voc2012", "mq2007", "image",
    "sentiment", "conll05", "flowers")] + [
    "paddle_tpu_torch.utils." + m for m in (
        "plot", "image_util", "plotcurve", "preprocess_util",
        "preprocess_img", "show_pb", "torch2paddle")]


def test_import_guard_walks_the_new_modules():
    walked = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    assert sorted(set(NEW_MODULES) - walked) == []
    # one module per file the JAX package has in dataset/ and utils/
    for sub in ("dataset", "utils"):
        want = {m.name for m in pkgutil.iter_modules(
            _mod(paddle_tpu, sub).__path__)}
        got = {m.name for m in pkgutil.iter_modules(
            _mod(paddle_tpu_torch, sub).__path__)}
        assert got == want
