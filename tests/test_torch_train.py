"""The port's training path against the JAX package: the loss and its
gradients, the optimizers, the data pipeline, the trainer with its
checkpoints, restarts and microbatching, checkpoints either package
wrote, and the committed full-width reference rows, on the same
numpy-made weights and batches. On the CPU kernels 5, 6, 7 and the
attention backward run as their plain versions.

Tolerances:
* reduced models (``ArchConfig.reduced()``, float32): the loss within 1e-6
  relative and every parameter's gradient within 5e-6 relative to its
  largest magnitude (measured 2.6e-7 and 1.1e-6: summation order; the
  reference's attention and scan are blockwise, the port's plain versions
  whole);
* optimizers over 3 steps: parameters and moments within 2e-6 relative to
  each leaf's largest magnitude (measured 3.1e-7: XLA fuses products and
  sums, the port rounds them apart, and the global-norm sum runs in
  another order); adafactor_m's bfloat16 first moment within one bfloat16
  step (measured 3.4e-3) and its parameters within 1e-3 (measured 2.5e-4),
  as a float32 ulp before the cast can pick the neighbouring bfloat16;
* the committed full-width reference (hymba-1.5b, 2 layers, float32; step
  0 here): ``benchmarks.pt_train.TRAIN_TOL``, as on the card. The CPU plain
  path is 9.5e-7 from the loss, 5e-6 from the gradient norm and 1.3e-7
  from the per-leaf norms; the adjoint shifted by one step moves the
  per-leaf norms by 2.1e-3, a window one key too wide in the attention
  backward by 6.7e-5.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import pt_train  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.models.layers import single_device_rules  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.layers import numpy_params  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    TrainConfig, Trainer, make_microbatched_train_step)
from torch_threads import one_thread  # noqa: E402,F401  (fixture)

ROOT = os.path.join(os.path.dirname(__file__), "..")
REFERENCE = os.path.join(ROOT, "artifacts", "bench_cache_torch",
                         "jax_train_reference.json")
LOSS_REL = 1e-6
GRAD_REL = 5e-6
OPT_REL = 2e-6
ADAFACTOR_PARAM_REL = 1e-3

# (arch, overrides of reduced()): hymba with GQA and a window its 48-token
# batches cross; yi-6b is the dense branch, falcon-mamba the pure-SSM one
VARIANTS = {
    "hymba": ("hymba-1.5b", dict(n_heads=4, n_kv_heads=2)),
    "yi": ("yi-6b", {}),
    "falcon-mamba": ("falcon-mamba-7b", {}),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def _configs(arch, over, **more):
    return (dataclasses.replace(get_config(arch).reduced(), **over, **more),
            dataclasses.replace(tget(arch).reduced(), **over, **more))


def _batch(cfg, B=2, S=48, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1  # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _port_model(tcfg, params):
    m = build_model(tcfg, device="cpu").load_params(
        convert.lm_params_from_jax(params, tcfg))
    return m.requires_grad_(True)


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradients_match_jax(variant):
    arch, over = VARIANTS[variant]
    jcfg, tcfg = _configs(arch, over)
    params = numpy_params(tcfg, 0)
    batch = _batch(tcfg)
    jm = jbuild(jcfg, single_device_rules(), None)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    tm = _port_model(tcfg, params)
    tl, tmet = tm.loss(batch)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert float(tmet["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    want = convert.lm_params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    for name, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), want[name].numpy()) <= GRAD_REL, name


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_loss_and_gradients(remat):
    """Per-layer activation checkpointing recomputes the same ops."""
    _, tcfg = _configs("hymba-1.5b", VARIANTS["hymba"][1])
    params, batch = numpy_params(tcfg, 0), _batch(tcfg)
    out = []
    for r in ("none", remat):
        m = _port_model(dataclasses.replace(tcfg, remat=r), params)
        loss, _ = m.loss(batch)
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in
                                    m.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in out[0][1].items():
        assert torch.equal(g, out[1][1][k]), k


def test_unknown_remat_raises():
    _, tcfg = _configs("yi-6b", {}, remat="most")
    m = _port_model(tcfg, numpy_params(tcfg, 0))
    with pytest.raises(ValueError, match="remat"):
        m.loss(_batch(tcfg))


# ------------------------------------------------------------- optimizers

def _grads(params, step):
    """Gradients per step, with a global norm above the clip of 1."""
    rng = np.random.default_rng(100 + step)
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape, np.float32) * 0.1)
        .astype(np.float32), params)


def _opt_limit(name, part, key):
    """OPT_REL, but for adafactor_m's bfloat16 first moment: a float32
    ulp apart before the cast can round it to neighbouring bfloat16
    values, one bfloat16 step (2**-7 relative), and each step's parameters
    move by lr times it (ADAFACTOR_PARAM_REL)."""
    if name != "adafactor_m":
        return OPT_REL
    if part == "params":
        return ADAFACTOR_PARAM_REL
    return 2.0 ** -7 if key.startswith("m.") else OPT_REL


@pytest.mark.parametrize("name", ["adamw", "adafactor_m"])
def test_optimizer_three_steps_match_jax(name):
    """Warmup, the cosine decay, clipping and bias correction over 3
    steps, on a reduced hymba tree (stacked layers in JAX, one tensor per
    layer in the port; adafactor_m factors the stacked leaves)."""
    _, tcfg = _configs("hymba-1.5b", {})
    params = numpy_params(tcfg, 0)
    ocfg = dict(lr=1e-2, warmup_steps=1, decay_steps=3, weight_decay=0.1,
                grad_clip=1.0)
    jo = jopt.get_optimizer(name, jopt.OptConfig(**ocfg))
    to = topt.get_optimizer(name, topt.OptConfig(**ocfg))
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = convert.lm_params_from_jax(params, tcfg)
    ts = to.init(tp)
    jupdate = jax.jit(jo.update)
    for step in range(3):
        g = _grads(params, step)
        jp, js, jn = jupdate(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.int32(step))
        _, ts, tn = to.update(convert.lm_params_from_jax(g, tcfg), ts, tp,
                              step)
        assert abs(float(tn) - float(jn)) <= OPT_REL * float(jn)
        assert float(jn) > 1.0  # clipped
    got = convert.train_state_to_jax({"params": tp, "opt": ts, "step": 3})
    want = {"params": jp, "opt": js}
    for part in ("params", "opt"):
        flat_w = convert.flatten(jax.tree.map(np.asarray, want[part]))
        flat_g = convert.flatten(got[part])
        assert set(flat_w) == set(flat_g)
        for k, w in flat_w.items():
            g = flat_g[k].float().numpy()
            assert g.shape == w.shape, k
            assert _rel(g, np.asarray(w, np.float32)) <= _opt_limit(
                name, part, k), (part, k)


def test_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=10, decay_steps=100)
    for step in (0, 5, 9, 10, 40, 99, 100, 150):
        assert float(topt._schedule(topt.OptConfig(**cfg), step)) == \
            float(jopt._schedule(jopt.OptConfig(**cfg), jnp.int32(step)))


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("step", [0, 3, 1000])
def test_synthetic_batches_bit_equal(step):
    for hosts, host in ((1, 0), (4, 2)):
        c = dict(vocab_size=32001, seq_len=64, global_batch=8, seed=5,
                 n_hosts=hosts, host_id=host)
        a = jdata.SyntheticLM(jdata.DataConfig(**c)).batch_at(step)
        b = tdata.SyntheticLM(tdata.DataConfig(**c)).batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_token_file_batches_bit_equal(tmp_path):
    path = str(tmp_path / "toks.bin")
    tdata.write_token_file(path, np.arange(5000) % 777)
    c = dict(vocab_size=777, seq_len=32, global_batch=4, seed=3)
    a = jdata.make_dataset(jdata.DataConfig(**c), path).batch_at(7)
    b = tdata.make_dataset(tdata.DataConfig(**c), path).batch_at(7)
    assert isinstance(tdata.make_dataset(tdata.DataConfig(**c), path),
                      tdata.TokenFileDataset)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------- trainer
# the twins of tests/test_runtime.py's training tests

def _arch(name="yi-6b"):
    return dataclasses.replace(tget(name).reduced(), capacity_factor=8.0)


def _tc(**kw):
    base = dict(total_steps=20, ckpt_every=5, log_every=100,
                opt=topt.OptConfig(lr=2e-3, warmup_steps=2, decay_steps=1000))
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.usefixtures("one_thread")
def test_train_loss_decreases():
    out = Trainer(_arch(), _tc(total_steps=30), device="cpu").run()
    assert out["steps_run"] == 30
    assert out["final_loss"] < out["first_loss"] - 0.3, out


@pytest.mark.usefixtures("one_thread")
def test_checkpoint_restart_resumes(tmp_path):
    root = str(tmp_path / "ckpt")
    out1 = Trainer(_arch(), _tc(total_steps=10, ckpt_dir=root),
                   device="cpu").run()
    out2 = Trainer(_arch(), _tc(total_steps=15, ckpt_dir=root),
                   device="cpu").run()
    assert out2["steps_run"] == 5
    assert out2["log"][0]["step"] == 10
    assert abs(out2["first_loss"] - out1["final_loss"]) < 0.5


@pytest.mark.usefixtures("one_thread")
def test_failure_recovery_replays_bit_equal(tmp_path):
    root = str(tmp_path / "ckpt")
    inj = fault.FailureInjector(fail_at=(7, 13))
    t = Trainer(_arch("hymba-1.5b"), _tc(total_steps=20, ckpt_dir=root),
                failure_injector=inj, device="cpu")
    out = t.run()
    assert inj.failures == 2 and out["restarts"] == 2
    assert out["log"][-1]["step"] == 19
    assert out["final_loss"] < out["first_loss"]
    # the steps replayed from the step-5 and step-10 checkpoints
    first = {}
    for rec in out["log"]:
        if rec["step"] in first:
            assert rec["loss"] == first[rec["step"]], rec
        first.setdefault(rec["step"], rec["loss"])
    assert [r["step"] for r in out["log"]].count(5) == 2


def test_microbatching_matches_full_batch():
    """Gradient accumulation over 4 microbatches == one full-batch step."""
    cfg = _arch("phi3-mini-3.8b")
    opt = topt.get_optimizer("adamw", topt.OptConfig(lr=1e-3,
                                                     warmup_steps=1))
    ds = tdata.SyntheticLM(tdata.DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=32, global_batch=8,
                                            seed=1))
    batch = {k: torch.as_tensor(v) for k, v in ds.batch_at(0).items()}
    outs = []
    for n in (1, 4):
        model = build_model(cfg, device="cpu")
        state = tsteps.init_train_state(
            model, opt, torch.Generator().manual_seed(0))
        state, m = make_microbatched_train_step(model, opt, n)(state, batch)
        outs.append((state, m))
    (s1, m1), (s4, m4) = outs
    assert abs(float(m1["total_loss"]) - float(m4["total_loss"])) < 1e-4
    assert max(float((s1["params"][k] - s4["params"][k]).detach().abs().max())
               for k in s1["params"]) < 5e-3
    assert s4["step"] == 1


def test_trainer_and_cli_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_arch(), _tc())
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "yi-6b", "--reduced", "--steps", "2"], capture_output=True,
        text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode != 0 and "CUDA" in out.stderr


def test_cli_trains_on_the_cpu():
    out = tlaunch.main(["--arch", "hymba-1.5b", "--reduced", "--device",
                        "cpu", "--steps", "6", "--seq-len", "32"])
    assert out["steps_run"] == 6 and np.isfinite(out["final_loss"])
    with pytest.raises(SystemExit, match="item 15"):
        tlaunch.main(["--arch", "yi-6b", "--coordinator", "host:1"])
    with pytest.raises(SystemExit):  # no multi-host flags without collectives
        tlaunch.main(["--arch", "yi-6b", "--num-hosts", "2"])


def test_embedding_backward_is_deterministic():
    """The token embedding's gradient sums repeated tokens in a fixed
    order on the CPU's threads, so a replayed step is bit-equal."""
    from repro_torch.models.layers import embed_tokens
    g = torch.Generator().manual_seed(0)
    emb = {"tok": torch.randn(2000, 64, generator=g, requires_grad=True)}
    tokens = torch.randint(0, 50, (8, 512), generator=g)
    dy = torch.randn(8, 512, 64, generator=g)
    grads = []
    for _ in range(8):
        emb["tok"].grad = None
        embed_tokens(emb, tokens, torch.float32).backward(dy)
        grads.append(emb["tok"].grad.clone())
    assert all(torch.equal(grads[0], x) for x in grads[1:])


# ----------------------------------------------------------- checkpoints

def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "opt": {"m": {"w": torch.zeros(3, 4), "b": torch.zeros(4)}},
            "step": np.int32(7)}


def test_checkpoint_roundtrip_keeps_dtypes(tmp_path):
    root = str(tmp_path)
    tckpt.save(root, 7, _state(), extra_meta={"loss": 1.25})
    out = tckpt.restore(root, _state())
    for k, v in convert.flatten(_state()).items():
        got = convert.flatten(out)[k]
        want = v if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.asarray(v))
        assert got.dtype == want.dtype and torch.equal(got, want), k
    assert tckpt.checkpoint_step_meta(root, 7)["loss"] == 1.25
    # bfloat16 is stored as raw bits plain numpy reads
    index = json.load(open(os.path.join(root, "step_00000007",
                                        "index.json")))
    entry = index["leaves"]["params/b"]
    assert entry["dtype"] == "bfloat16"
    assert np.load(os.path.join(root, "step_00000007",
                                entry["file"])).dtype == np.uint16
    bad = _state()
    bad["params"]["w"] = torch.zeros(5, 5)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(root, bad)


def test_latest_step_ignores_uncommitted(tmp_path):
    root = str(tmp_path)
    tckpt.save(root, 5, _state())
    os.makedirs(os.path.join(root, "step_00000009"))
    assert tckpt.latest_step(root) == 5


def test_async_snapshot_isolated_from_in_place_updates(tmp_path):
    """The trainer updates parameters in place right after save()."""
    root = str(tmp_path)
    ac = tckpt.AsyncCheckpointer(root, keep=2)
    state = {"w": torch.ones(4)}
    for step in (1, 2, 3):
        ac.save(step, state)
        state["w"].mul_(100.0)
    ac.wait()
    assert sorted(os.listdir(root)) == ["step_00000002", "step_00000003"]
    out = tckpt.restore(root, {"w": torch.zeros(4)})
    assert torch.equal(out["w"], torch.full((4,), 1e4))


def test_resumes_a_jax_written_checkpoint(tmp_path):
    """A float32 checkpoint the JAX package's checkpoint.save wrote (its
    train state after 2 steps) restores into the port's trainer, which
    resumes at step 2 with the JAX run's parameters and moments, and its
    next loss is JAX's."""
    from repro.launch.steps import init_train_state, make_train_step
    jcfg, tcfg = _configs("hymba-1.5b", VARIANTS["hymba"][1])
    jm = jbuild(jcfg, single_device_rules(), None)
    ocfg = dict(lr=2e-3, warmup_steps=2, decay_steps=1000)
    jo = jopt.get_optimizer("adamw", jopt.OptConfig(**ocfg))
    data = tdata.SyntheticLM(tdata.DataConfig(
        vocab_size=tcfg.vocab_size, seq_len=64, global_batch=8, seed=0))
    state = init_train_state(jm, jo, jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(jm, jo))
    for i in range(2):
        state, _ = step(state, jax.tree.map(jnp.asarray, data.batch_at(i)))
    _, m2 = step(state, jax.tree.map(jnp.asarray, data.batch_at(2)))
    root = str(tmp_path / "ckpt")
    jckpt.save(root, 2, state)
    t = Trainer(tcfg, _tc(total_steps=3, ckpt_dir=root,
                          opt=topt.OptConfig(**ocfg)), device="cpu")
    got, start = t._init_or_restore()
    assert start == 2
    want = convert.train_state_from_jax(jax.tree.map(np.asarray, state))
    for part in ("params",):
        for k, w in want[part].items():
            assert torch.equal(got[part][k].detach(), w), k
    for k, w in want["opt"]["v"].items():
        assert torch.equal(got["opt"]["v"][k], w), k
    out = t.run()
    assert [r["step"] for r in out["log"]] == [2]
    assert abs(out["log"][0]["loss"] - float(m2["total_loss"])) <= \
        LOSS_REL * float(m2["total_loss"])


# ------------------------------------------------- full-width reference

@pytest.mark.usefixtures("one_thread")
def test_full_width_step0_matches_committed_reference():
    """hymba-1.5b at full width, 2 layers, float32, one step of the
    committed reference rows (``pt_jax_reference.py --only train``): the
    loss, the global gradient norm, every leaf's gradient norm and its
    probed gradient elements."""
    ref = json.load(open(REFERENCE))
    assert ref["config"]["n_layers"] == 2
    got = pt_train.reference_run("cpu", ref, steps=1)
    err = pt_train.reference_errors(got, ref)
    for k, limit in pt_train.TRAIN_TOL.items():
        if err[k] is not None:
            assert err[k] <= limit, (k, err[k])
    assert set(got["grad0"]) == set(ref["grad0"])


@pytest.mark.cuda
def test_kernel_path_gradients_match_plain_on_card():
    """Needs an NVIDIA card (sm_90a) and nvcc: a reduced hymba's loss and
    gradients through FlashAttentionFn and SelectiveScanFn (kernels 5, 6, 7
    and the attention backward) against the plain versions on the card;
    chip_smoke.py runs the full-width comparisons."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    _, tcfg = _configs("hymba-1.5b", dict(n_heads=4, n_kv_heads=2,
                                          head_dim=64, remat="full"))
    params, batch = numpy_params(tcfg, 0), _batch(tcfg)
    out = []
    for core in ("kernel", "plain"):
        m = build_model(tcfg, device="cuda", core=core).load_params(
            convert.lm_params_from_jax(params, tcfg)).requires_grad_(True)
        loss, _ = m.loss(batch)
        loss.backward()
        out.append((float(loss), {k: p.grad.cpu() for k, p in
                                  m.named_parameters()}))
    assert abs(out[0][0] - out[1][0]) <= LOSS_REL * abs(out[1][0])
    for k, g in out[0][1].items():
        assert _rel(g.numpy(), out[1][1][k].numpy()) <= 2e-5, k
