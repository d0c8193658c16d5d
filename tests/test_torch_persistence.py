"""The Fluid surface's stragglers in the port, against the JAX package, on
the CPU.

- Persistence (``fluid/io.py``): ``__persistables__.npz`` from
  ``save_persistables``, ``fluid.save``'s ``.pdparams.npz`` and
  ``.pdmodel.json`` and the inference pair's directories, each written by
  one package and read by the other, to equal arrays of equal dtypes:
  the parameters, Adam moments and beta powers, batch-norm statistics,
  the learning-rate counter, and the loss-scaling state of a dynamically
  scaled step (``decorate(use_bf16=False)``; with ``use_bf16=True`` the
  reference's ``decorate`` keeps no loss scale, in both packages). A
  bfloat16 persistable is stored as the JAX package stores it, its bits
  under numpy's void ``V2``, and read back as bfloat16.
- ``set_program_state`` refuses a wrong shape with the reference's
  error; ``use_orbax`` and ``load_latest_persistables`` go to the
  step-managed store (parallel/checkpoint.py; tests/
  test_torch_checkpoint.py holds it against the JAX package's).
- Resume: 2k Adam steps with dropout equal k steps, ``save_persistables``,
  a fresh scope, ``load_persistables`` and k more steps on the same
  Executor, bit for bit (the executor's run count seeds each step's
  dropout draws, so the resumed steps draw as the uninterrupted ones).
- The signatures of ``Executor.run``, the inference pair and
  ``DecodeEngine.__init__`` list the reference's parameters in its order
  (faults 8-10), and positional arguments bind as they do there.
- ``Executor.close``, ``Scope.pop``/``drop_kids``, ``Variable.astype``,
  ``Program.desc_version``, ``Predictor.profile``'s keys, the new
  ``fluid`` and ``fluid.core`` names, ``paddle_tpu_torch.version()``, and
  the names the port leaves out because they name the TPU.
- ``DecodeEngine(build_prefill=, build_step=)`` with GPT's own builders
  serves the tokens the default engine serves.
"""
import inspect
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jax_executor
from paddle_tpu.fluid import framework as jax_framework
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name


@pytest.fixture(autouse=True)
def _fresh_state():
    """Fresh default programs, name generators and scopes of both
    packages."""
    old = (pt_framework.switch_main_program(pt_framework.Program()),
           pt_framework.switch_startup_program(pt_framework.Program()),
           pt_unique_name.switch(), pt_executor._scope_stack[:],
           jax_framework.switch_main_program(jax_framework.Program()),
           jax_framework.switch_startup_program(jax_framework.Program()),
           jax_unique_name.switch(), jax_executor._scope_stack[:])
    pt_executor._scope_stack[:] = [pt_executor.Scope()]
    jax_executor._scope_stack[:] = [jax_executor.Scope()]
    yield
    pt_framework.switch_main_program(old[0])
    pt_framework.switch_startup_program(old[1])
    pt_unique_name.switch(old[2])
    pt_executor._scope_stack[:] = old[3]
    jax_framework.switch_main_program(old[4])
    jax_framework.switch_startup_program(old[5])
    jax_unique_name.switch(old[6])
    jax_executor._scope_stack[:] = old[7]


def _net(fl, amp):
    """conv + batch norm + dropout + fc, Adam under an exponential decay
    (its counter is a persistable), decorated as `amp` says."""
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.data("x", [None, 3, 8, 8], "float32")
        y = fl.data("y", [None, 1], "int64")
        h = fl.layers.conv2d(x, 4, 3, padding=1)
        h = fl.layers.batch_norm(h, act="relu")
        h = fl.layers.dropout(h, 0.1)
        logits = fl.layers.fc(h, 5)
        loss = fl.layers.mean(
            fl.layers.softmax_with_cross_entropy(logits, y))
        opt = fl.optimizer.Adam(fl.layers.exponential_decay(1e-2, 10, 0.5))
        if amp is not None:
            opt = fl.contrib.mixed_precision.decorate(opt, **amp)
        opt.minimize(loss)
    main.random_seed = startup.random_seed = 3
    return main, startup, loss, logits


AMPS = {"f32": None,
        "bf16": dict(use_bf16=True),
        "dynamic_scaling": dict(use_bf16=False, init_loss_scaling=2.0 ** 10)}


def _feed(i):
    rng = np.random.default_rng(i)
    return {"x": rng.normal(size=(4, 3, 8, 8)).astype("float32"),
            "y": rng.integers(0, 5, (4, 1)).astype("int64")}


def _trained(fl, amp, steps=2, place=None):
    main, startup, loss, logits = _net(fl, AMPS[amp])
    exe = fl.Executor(place or fl.CPUPlace())
    exe.run(startup)
    for i in range(steps):
        exe.run(main, feed=_feed(i), fetch_list=[loss])
    return main, exe, logits


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _host(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view("V2")
        return v.numpy()
    return np.asarray(v)


def _assert_same_arrays(got, want, names):
    for n in names:
        a, w = _host(got[n]), _host(want[n])
        assert a.dtype == w.dtype and a.shape == w.shape, (n, a.dtype,
                                                            w.dtype)
        assert a.tobytes() == w.tobytes(), n


@pytest.mark.parametrize("amp", sorted(AMPS))
def test_persistables_written_by_jax_load_in_the_port(amp, tmp_path):
    jmain, jexe, _ = _trained(jfluid, amp)
    names = _persistables(jmain)
    if amp == "dynamic_scaling":
        assert any(n.startswith("amp_loss_scaling") for n in names)
        assert any(n.startswith("amp_good_steps") for n in names)
    jfluid.io.save_persistables(jexe, str(tmp_path), jmain)
    pmain, _, _, _ = _net(fluid, AMPS[amp])
    assert _persistables(pmain) == names
    fluid.io.load_persistables(fluid.Executor(fluid.CPUPlace()),
                               str(tmp_path), pmain)
    _assert_same_arrays(fluid.global_scope(), jfluid.global_scope(), names)


@pytest.mark.parametrize("amp", sorted(AMPS))
def test_persistables_written_by_the_port_load_in_jax(amp, tmp_path):
    pmain, pexe, _ = _trained(fluid, amp)
    names = _persistables(pmain)
    fluid.io.save_persistables(pexe, str(tmp_path), pmain)
    jmain, _, _, _ = _net(jfluid, AMPS[amp])
    jfluid.io.load_persistables(jfluid.Executor(jfluid.CPUPlace()),
                                str(tmp_path), jmain)
    _assert_same_arrays(jfluid.global_scope(), fluid.global_scope(), names)
    # the loaded state trains on in the JAX package
    out = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=_feed(9),
        fetch_list=[jmain.global_block().var(_loss_name(jmain))])[0]
    assert np.isfinite(out).all()


def _loss_name(main):
    return next(op.output("Out")[0] for op in main.global_block().ops
                if op.type == "mean")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fluid_save_files_cross_both_ways(writer, tmp_path):
    path = str(tmp_path / "model")
    src, dst = (jfluid, fluid) if writer == "jax" else (fluid, jfluid)
    smain, _, _ = _trained(src, "dynamic_scaling")
    src.save(smain, path)
    assert os.path.exists(path + ".pdparams.npz")
    with open(path + ".pdmodel.json") as f:
        assert json.loads(f.read()) == json.loads(smain.to_json())
    dmain, _, _, _ = _net(dst, AMPS["dynamic_scaling"])
    dst.load(dmain, path)
    names = _persistables(smain)
    _assert_same_arrays(dst.global_scope(), src.global_scope(), names)
    state = dst.io.load_program_state(path)
    assert sorted(state) == names
    for n in names:
        np.testing.assert_array_equal(state[n], _host(
            src.global_scope()[n]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_inference_models_cross_both_ways(writer, tmp_path):
    src, dst = (jfluid, fluid) if writer == "jax" else (fluid, jfluid)
    smain, sexe, logits = _trained(src, "f32")
    test_prog = smain.clone(for_test=True)
    src.io.save_inference_model(str(tmp_path), ["x"], [logits], sexe,
                                test_prog)
    dexe = dst.Executor(dst.CPUPlace())
    prog, feeds, fetches = dst.io.load_inference_model(str(tmp_path), dexe)
    assert feeds == ["x"]
    for p in prog.all_parameters():
        np.testing.assert_array_equal(_host(dst.global_scope()[p.name]),
                                      _host(src.global_scope()[p.name]))
    x = _feed(5)["x"]
    got = dexe.run(prog, feed={"x": x}, fetch_list=fetches)[0]
    with src.scope_guard(src.Scope()):
        sprog, _, sfetches = src.io.load_inference_model(str(tmp_path), sexe)
        want = sexe.run(sprog, feed={"x": x}, fetch_list=sfetches)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _bf16_param_program(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        fl.layers.create_parameter(
            shape=[3, 4], dtype="bfloat16", name="w_bf16",
            default_initializer=fl.initializer.Constant(0.1))
    return main


def test_bfloat16_persistables_are_stored_as_the_jax_package_stores_them(
        tmp_path):
    import ml_dtypes

    w = (np.arange(12, dtype=np.float32).reshape(3, 4) / 7 - 0.5).astype(
        ml_dtypes.bfloat16)
    jmain = _bf16_param_program(jfluid)
    jfluid.global_scope().set("w_bf16", w)
    jfluid.io.save_persistables(None, str(tmp_path / "j"), jmain)
    jfile = np.load(str(tmp_path / "j" / "__persistables__.npz"))["w_bf16"]
    assert jfile.dtype == np.dtype("V2")

    pmain = _bf16_param_program(fluid)
    fluid.io.load_persistables(None, str(tmp_path / "j"), pmain)
    got = fluid.global_scope()["w_bf16"]
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == w.tobytes()

    fluid.io.save_persistables(None, str(tmp_path / "p"), pmain)
    pfile = np.load(str(tmp_path / "p" / "__persistables__.npz"))["w_bf16"]
    assert pfile.dtype == jfile.dtype and pfile.tobytes() == jfile.tobytes()


def test_zero_d_counters_stay_zero_d(tmp_path):
    values = {jfluid: np.asarray(np.int32(7)),
              fluid: torch.tensor(7, dtype=torch.int32)}
    for fl, d in ((jfluid, "j"), (fluid, "p")):
        main = fl.Program()
        v = main.global_block().create_var(name="step_counter", shape=(),
                                           dtype="int32")
        v.persistable = True
        fl.global_scope().set("step_counter", values[fl])
        fl.io.save_persistables(None, str(tmp_path / d), main)
    a = np.load(str(tmp_path / "j" / "__persistables__.npz"))["step_counter"]
    b = np.load(str(tmp_path / "p" / "__persistables__.npz"))["step_counter"]
    assert a.shape == b.shape == () and a.dtype == b.dtype == np.int32
    assert int(a) == int(b) == 7


def test_set_program_state_refuses_a_wrong_shape_as_the_reference_does():
    errors = []
    for fl in (jfluid, fluid):
        main, _, _, _ = _net(fl, None)
        state = {"fc_0.w_0": np.zeros((3, 5), np.float32)}
        with pytest.raises(ValueError) as e:
            fl.io.set_program_state(main, state)
        errors.append(str(e.value))
        fl.io.set_program_state(main, {"fc_0.w_1": np.ones(5, np.float32)})
        np.testing.assert_array_equal(_host(fl.global_scope()["fc_0.w_1"]),
                                      np.ones(5, np.float32))
    assert errors[0] == errors[1]
    assert "shape mismatch for 'fc_0.w_0'" in errors[1]


def test_orbax_paths_wait_for_item_8_6(tmp_path):
    """Item 8.6 is in: the orbax paths save and load every persistable
    (Adam moments, batch-norm statistics, the decay counter) through the
    step-managed store."""
    main, startup, loss, _ = _net(fluid, None)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    exe.run(main, feed=_feed(0), fetch_list=[loss])
    d = str(tmp_path / "steps")
    assert fluid.io.load_latest_persistables(exe, d, main) is None
    fluid.io.save_persistables(exe, d, main, use_orbax=True, step=3)
    scope = fluid.global_scope()
    names = [v.name for v in main.list_vars()
             if v.persistable and scope.find_value(v.name) is not None]
    want = {n: scope[n].clone() for n in names}
    for n in names:
        scope.set(n, torch.zeros_like(want[n]))
    assert fluid.io.load_latest_persistables(exe, d, main) == 3
    for n in names:
        assert torch.equal(torch.as_tensor(scope[n]), want[n]), n
    for n in names:
        scope.set(n, torch.zeros_like(want[n]))
    fluid.io.load_persistables(exe, d, main, use_orbax=True, step=3)
    for n in names:
        assert torch.equal(torch.as_tensor(scope[n]), want[n]), n


def test_program_helpers_match_the_jax_package():
    names = []
    for fl in (jfluid, fluid):
        main, _, _, _ = _net(fl, None)
        names.append((
            [v.name for v in fl.io.get_program_persistable_vars(main)],
            [p.name for p in fl.io.get_program_parameter(main)]))
        batches = list(fl.io.batch(lambda: iter(range(7)), 3)())
        assert batches == [[0, 1, 2], [3, 4, 5], [6]]
    assert names[0] == names[1]


# ---------------------------------------------------------------------------
# resume: k + save + fresh scope + load + k == 2k, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("amp", ["f32", "dynamic_scaling", "bf16"])
def test_resume_equals_the_uninterrupted_run_bit_for_bit(amp, tmp_path):
    k = 3
    main, startup, loss, _ = _net(fluid, AMPS[amp])
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)

    def fresh():
        scope = fluid.Scope()
        for n, t in init.items():
            scope.set(n, t.clone())
        return scope

    # A: 2k steps without a break
    exe_a, scope_a = fluid.Executor(fluid.CPUPlace()), fresh()
    losses_a = [exe_a.run(main, feed=_feed(i), fetch_list=[loss],
                          scope=scope_a)[0] for i in range(2 * k)]
    # B: k steps, save, a fresh scope, load, k steps, one executor
    exe_b, scope_b = fluid.Executor(fluid.CPUPlace()), fresh()
    losses_b = [exe_b.run(main, feed=_feed(i), fetch_list=[loss],
                          scope=scope_b)[0] for i in range(k)]
    with fluid.scope_guard(scope_b):
        fluid.io.save_persistables(exe_b, str(tmp_path), main)
    resumed = fluid.Scope()
    with fluid.scope_guard(resumed):
        fluid.io.load_persistables(exe_b, str(tmp_path), main)
        losses_b += [exe_b.run(main, feed=_feed(i), fetch_list=[loss])[0]
                     for i in range(k, 2 * k)]
    assert [x.tobytes() for x in losses_b] == [x.tobytes() for x in losses_a]
    names = _persistables(main)
    assert set(names) <= set(resumed.keys())
    _assert_same_arrays(resumed, scope_a, names)
    # the resumed steps really moved the state off the saved one
    saved = np.load(str(tmp_path / "__persistables__.npz"))
    assert saved["fc_0.w_0"].tobytes() != _host(resumed["fc_0.w_0"]).tobytes()


# ---------------------------------------------------------------------------
# faults 8-10: the reference's signatures
# ---------------------------------------------------------------------------
def _params(fn):
    return list(inspect.signature(fn).parameters)


def test_signatures_list_the_reference_parameters_in_its_order():
    from paddle_tpu.serving.decode import DecodeEngine as JaxDecodeEngine
    from paddle_tpu_torch.serving.decode import DecodeEngine

    pairs = [(fluid.Executor.run, jfluid.Executor.run),
             (fluid.io.save_inference_model, jfluid.io.save_inference_model),
             (fluid.io.load_inference_model, jfluid.io.load_inference_model),
             (DecodeEngine.__init__, JaxDecodeEngine.__init__)]
    for port_fn, ref_fn in pairs:
        ref = _params(ref_fn)
        got = _params(port_fn)
        # the port may add parameters only after the reference's
        assert got[:len(ref)] == ref, (port_fn.__qualname__, got, ref)
    assert _params(fluid.Executor.run) == _params(jfluid.Executor.run)
    assert _params(fluid.io.load_inference_model) == _params(
        jfluid.io.load_inference_model)


def test_positional_arguments_bind_as_in_the_reference(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 4], "float32")
        y = fluid.layers.fc(x, 3)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, None, None, "feed", "fetch", scope)
    assert "fc_0.w_0" in scope
    out = exe.run(main, {"x": np.ones((2, 4), np.float32)}, [y], "feed",
                  "fetch", scope, False, True, False)[0]
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (2, 3)
    out = exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                  fetch_list=[y], scope=scope, use_program_cache=False,
                  use_prune=True, feed_var_name="f", fetch_var_name="g")[0]
    assert out.shape == (2, 3)
    # save_inference_model's eighth is export_for_deployment, not
    # program_only: the parameters are written
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe, main,
                                      None, None, True)
    assert os.path.exists(str(tmp_path / "__params__.npz"))
    # load_inference_model's fifth is pserver_endpoints, not the scope
    fresh = fluid.Scope()
    with fluid.scope_guard(fresh):
        fluid.io.load_inference_model(str(tmp_path), exe, None, None,
                                      ["127.0.0.1:0"])
    assert "fc_0.w_0" in fresh


# ---------------------------------------------------------------------------
# methods and names
# ---------------------------------------------------------------------------
def test_executor_close_then_run_raises_as_the_reference():
    for fl in (jfluid, fluid):
        exe = fl.Executor(fl.CPUPlace())
        exe.run(fl.Program())
        exe.close()
        exe.close()
        with pytest.raises(RuntimeError, match="Executor is closed"):
            exe.run(fl.Program())


def test_scope_pop_and_drop_kids():
    for fl in (jfluid, fluid):
        scope = fl.Scope()
        scope.set("a", np.ones(2))
        kid = scope.new_scope()
        kid.set("b", np.zeros(1))
        assert kid.find_var("a") is not None
        assert np.array_equal(scope.pop("a"), np.ones(2))
        assert scope.pop("a", "gone") == "gone" and "a" not in scope
        assert scope._kids == [kid]
        scope.drop_kids()
        assert scope._kids == []


def _astype_program(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.data("x", [None, 4], "float32")
        w = fl.layers.create_parameter([4], "float32", name="p")
        a = x.astype("float16")
        b = w.astype("int32")
    return main, a, b


def test_astype_is_a_cast_and_desc_version_counts_changes():
    jmain, _, _ = _astype_program(jfluid)
    pmain, a, b = _astype_program(fluid)
    assert pmain.to_json() == jmain.to_json()
    assert [op.type for op in pmain.global_block().ops] == ["cast", "cast"]
    assert isinstance(pmain.global_block().var("p"), fluid.Parameter)
    exe = fluid.Executor(fluid.CPUPlace())
    fluid.global_scope().set("p", np.array([1.5, -2.5, 3.0, 0.2],
                                           np.float32))
    out_a, out_b = exe.run(pmain, feed={"x": np.full((2, 4), 0.1,
                                                     np.float32)},
                           fetch_list=[a, b])
    assert out_a.dtype == np.float16 and out_b.dtype == np.int32
    np.testing.assert_array_equal(out_b, [1, -2, 3, 0])
    v0 = pmain.desc_version()
    with fluid.program_guard(pmain):
        fluid.layers.scale(a, 2.0)
    assert pmain.desc_version() > v0


def test_predictor_profile_has_the_jax_package_keys(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 4], "float32")
        y = fluid.layers.fc(x, 3)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    fluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe, main)
    pred = fluid.Predictor.from_model(str(tmp_path), place=fluid.CPUPlace())
    jpred = jfluid.inference.Predictor.from_model(str(tmp_path),
                                        place=jfluid.CPUPlace())
    for n in (2, 3, 2):
        pred.run({"x": np.ones((n, 4), np.float32)})
        jpred.run({"x": np.ones((n, 4), np.float32)})
    prof, jprof = pred.profile(), jpred.profile()
    assert sorted(prof) == sorted(jprof)
    assert prof["n_engines"] == jprof["n_engines"] == 2
    assert prof["n_params"] == jprof["n_params"] == 2
    assert sorted(prof["compile_seconds"]) == sorted(jprof["compile_seconds"])
    assert all(s >= 0 for s in prof["compile_seconds"].values())


NEW_FLUID_NAMES = (
    "GradClipByValue", "GradClipByNorm", "GradClipByGlobalNorm",
    "dygraph_grad_clip", "learning_rate_decay", "layer_helper_base",
    "Tensor", "LoDTensorArray", "save", "load", "require_version",
    "load_op_library", "is_compiled_with_cuda", "in_dygraph_mode",
    "cuda_pinned_places", "CUDAPinnedPlace")


@pytest.mark.parametrize("name", NEW_FLUID_NAMES)
def test_new_fluid_names_are_there(name):
    assert hasattr(jfluid, name)
    got = getattr(fluid, name)
    want = getattr(jfluid, name)
    assert type(got) is type(want) or (callable(got) and callable(want))


def test_new_names_behave_as_the_reference():
    assert fluid.in_dygraph_mode() is False
    assert fluid.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert fluid.Tensor is np.ndarray
    assert fluid.LoDTensorArray([1, 2]) == [1, 2]
    assert fluid.learning_rate_decay.exponential_decay is \
        fluid.layers.exponential_decay
    assert fluid.GradClipByValue is fluid.dygraph_grad_clip.GradClipByValue
    places = fluid.cuda_pinned_places(2)
    assert places == [fluid.core.CUDAPinnedPlace(0),
                      fluid.core.CUDAPinnedPlace(1)]
    assert isinstance(places[0], fluid.CPUPlace)
    assert places[0].torch_device() == torch.device("cpu")
    assert fluid.core.globals_flags() == jfluid.core.globals_flags()
    assert paddle_tpu_torch.version() == paddle_tpu.version()
    fluid.require_version("0.0.1")
    fluid.require_version("0.1.0", "0.2")
    for fl in (jfluid, fluid):
        with pytest.raises(Exception, match="version >= 9.0 is required"):
            fl.require_version("9.0")
        with pytest.raises(ValueError, match="should have format"):
            fl.require_version("one")
        with pytest.raises(TypeError):
            fl.require_version(1.0)
        with pytest.raises(NotImplementedError, match="was not loaded"):
            fl.load_op_library("libcustom.so")


@pytest.mark.parametrize("module, name", [
    ("fluid", "TPUPlace"), ("fluid", "tpu_places"),
    ("fluid", "is_compiled_with_tpu"), ("core", "TPUPlace"),
    ("core", "is_compiled_with_tpu"), ("framework", "tpu_places")])
def test_tpu_names_are_left_out_of_the_port(module, name):
    """The JAX package has these; the port runs on a card, and a script
    that asks for the TPU should fail where it asks."""
    ref = {"fluid": jfluid, "core": jfluid.core,
           "framework": jfluid.framework}[module]
    port = {"fluid": fluid, "core": fluid.core,
            "framework": fluid.framework}[module]
    assert hasattr(ref, name)
    assert not hasattr(port, name)


# ---------------------------------------------------------------------------
# fault 10: DecodeEngine's builders
# ---------------------------------------------------------------------------
def test_decode_engine_takes_the_builders_in_the_reference_positions():
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving.decode import DecodeEngine

    cfg = gpt.gpt_tiny(vocab=97, max_len=64)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    with fluid.program_guard(main, startup):
        gpt.build_gpt_lm(cfg, 8)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    params = {p.name: scope[p.name].clone() for p in main.all_parameters()}
    calls = {"prefill": 0, "step": 0}

    def prefill(c, bucket, cache_len):
        calls["prefill"] += 1
        return gpt.build_gpt_prefill(c, bucket, cache_len)

    def step(c, cache_len):
        calls["step"] += 1
        return gpt.build_gpt_decode_step(c, cache_len)

    prompt = np.random.default_rng(3).integers(1, 97, 6).astype("int64")
    streams = []
    engines = [
        DecodeEngine(cfg, params, slots=2, cache_len=32,
                     prompt_buckets=(8,), place=fluid.CPUPlace()),
        DecodeEngine(cfg, params, slots=2, cache_len=32,
                     prompt_buckets=(8,), build_prefill=prefill,
                     build_step=step, place=fluid.CPUPlace()),
        # positionally, as a script written for the reference passes them
        DecodeEngine(cfg, params, 2, 32, (8,), None, 64, 32, None, 60.0,
                     "positional", False, True, prefill, step,
                     place=fluid.CPUPlace()),
    ]
    try:
        for eng in engines:
            streams.append(list(eng.submit(prompt, max_new=6).tokens(
                timeout=60.0)))
    finally:
        for eng in engines:
            eng.stop(drain=False, timeout=60.0)
    assert calls == {"prefill": 2, "step": 2}
    assert engines[2].name == "positional" and engines[2].kv_dtype == "fp32"
    assert len(streams[0]) == 6 and streams[1] == streams[0] == streams[2]
