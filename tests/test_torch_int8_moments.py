"""The port's 8-bit Adam moments (``flexynesis_torch/ops/sr_adam.py``
``moment_dtype="int8"`` / ``"int8_m"``, ``ops/optim.py``'s fallback,
``parallel/trials.py``'s ``ParallelTrials(moment_dtype=...)``) against
``flexynesis_tpu/ops/sr_adam.py`` on the same numpy inputs:

* ``q8_encode_m``: codes and scales bit for bit at several shapes and
  seeds, with a trial axis against ``vmap``, and ``q8_decode_m`` bit for
  bit; ``q8_encode_v``: scales within rtol 1e-3 (XLA's float32 square root on
  the CPU is not always torch's: one ulp on under 1% of the rows in most
  runs, 2.5e-4 on half the rows of one case in one run)
  and codes equal but for at most 2% of them differing by one (a code
  whose ``e + u`` sits on an integer flips with its row's scale);
  ``q8_decode_v`` of JAX's own codes within four float32 ulp (jnp's
  ``exp2`` lowers to XLA's ``exp(ln2 * x)``, whose ``exp`` differs from
  torch's in the last place on some codes, and v is its square; measured
  at most 2.6 ulp);
* ``sr_adam_init(moment_dtype="int8" | "int8_m")``: the same structure,
  types, shapes and values (m codes 0, v codes 255, scales 1e-30);
* three ``sr_adam_step``s with int8 and int8_m moments, unstacked and with a
  trial axis (per-trial lr and seed): float32 leaves and the bfloat16
  parameters within one bfloat16 ulp (2^-8 relative), the moment codes
  equal but for at most 2% of them differing by one (a decoded v or a
  scale that differs in the last place moves a dithered code across an
  integer; the fraction measured here is under 1%) and the scales within
  rtol 1e-5;
* the int8 moments track float32 Adam over 40 steps (JAX's test);
* ``trial_optimizer("int8")`` outside SR stores bfloat16 moments, as JAX's
  falls back;
* a ``ParallelTrials`` round with int8 moments converges like JAX's test
  asks (within 15% of the float32 round, or below 0.25), its big leaves hold
  ``Q8`` moments, and a round checkpointed mid-way resumes bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.ops import sr_adam as jax_sr
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.ops import sr_adam
from flexynesis_torch.ops.optim import trial_optimizer
from flexynesis_torch.parallel import trials
from flexynesis_torch.parallel.trials import ParallelTrials
from torch_one_thread import one_torch_thread  # noqa: F401

SEEDS = [0, 5, 12345, 2**32 - 1]
CODE_SHARE = 0.02  # of a moment's codes, the most that may differ (by one) from JAX's
# v's row scales: one float32 ulp in most runs; one run of this file measured
# 2.5e-4 on half the rows of one case (XLA's CPU square root was not torch's)
V_SCALE_RTOL = 1e-3


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


@pytest.mark.parametrize("shape", [(64, 33), (3, 128, 40)])
@pytest.mark.parametrize("seed", SEEDS)
def test_codecs_match_jax(shape, seed):
    rng = np.random.default_rng(seed % 1000)
    m = (rng.normal(size=shape) * 1e-3).astype(np.float32)
    v = ((rng.exponential(size=shape) * 1e-3) ** 2).astype(np.float32)
    jm, pm = jax_sr.q8_encode_m(jnp.asarray(m), jnp.uint32(seed)), \
        sr_adam.q8_encode_m(torch.from_numpy(m), seed)
    assert pm.q.dtype == torch.int8 and pm.s.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(pm.q.numpy(), np.asarray(jm["q"]))
    np.testing.assert_array_equal(pm.s.numpy(), np.asarray(jm["s"]))
    np.testing.assert_array_equal(sr_adam.q8_decode_m(pm).numpy(),
                                  np.asarray(jax_sr.q8_decode_m(jm)))
    jv, pv = jax_sr.q8_encode_v(jnp.asarray(v), jnp.uint32(seed)), \
        sr_adam.q8_encode_v(torch.from_numpy(v), seed)
    assert pv.q.dtype == torch.uint8
    _assert_codes_close(pv.q, np.asarray(jv["q"]))
    np.testing.assert_allclose(pv.s.numpy(), np.asarray(jv["s"]), rtol=V_SCALE_RTOL, atol=0)
    # decoded from JAX's own codes and scales
    want = np.asarray(jax_sr.q8_decode_v(jv))
    got = sr_adam.q8_decode_v(sr_adam.Q8(torch.from_numpy(np.array(jv["q"])),
                                          torch.from_numpy(np.array(jv["s"])))).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -21, atol=0)


def _assert_codes_close(got: torch.Tensor, want: np.ndarray) -> None:
    """Codes equal but for at most CODE_SHARE of them, each by one."""
    diff = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= CODE_SHARE, (diff.max(), (diff > 0).mean())


def test_codecs_with_a_trial_axis_match_vmap():
    rng = np.random.default_rng(1)
    m = (rng.normal(size=(3, 40, 24)) * 1e-2).astype(np.float32)
    seeds = np.array([3, 2**32 - 2, 77], np.uint32)
    want = jax.vmap(jax_sr.q8_encode_m)(jnp.asarray(m), jnp.asarray(seeds))
    got = sr_adam.q8_encode_m(torch.from_numpy(m), torch.from_numpy(seeds.astype(np.int64)),
                              trial_axis=True)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want["s"]))
    want = jax.vmap(jax_sr.q8_encode_v)(jnp.asarray(m * m), jnp.asarray(seeds))
    got = sr_adam.q8_encode_v(torch.from_numpy(m * m), torch.from_numpy(seeds.astype(np.int64)),
                              trial_axis=True)
    _assert_codes_close(got.q, np.asarray(want["q"]))


def test_zero_moments_decode_to_zero():
    x = torch.zeros(4, 128)
    for s in (0, 1, 999):
        assert torch.all(sr_adam.q8_decode_m(sr_adam.q8_encode_m(x, s)) == 0)
        assert float(sr_adam.q8_decode_v(sr_adam.q8_encode_v(x, s)).max()) < 1e-30


@pytest.mark.parametrize("moment_dtype", ["int8", "int8_m"])
def test_init_matches_jax(moment_dtype):
    j = {"big": jnp.zeros((512, 256), jnp.bfloat16), "small": jnp.zeros((8,), jnp.float32)}
    jm, jv, _ = jax_sr.sr_adam_init(j, moment_dtype=moment_dtype)
    state = sr_adam.sr_adam_init([torch.zeros(512, 256, dtype=torch.bfloat16),
                                  torch.zeros(8)], moment_dtype)
    assert isinstance(state.m[0], sr_adam.Q8) and state.m[1].dtype == torch.float32
    np.testing.assert_array_equal(state.m[0].q.numpy(), np.asarray(jm["big"]["q"]))
    np.testing.assert_array_equal(state.m[0].s.numpy(), np.asarray(jm["big"]["s"]))
    if moment_dtype == "int8":
        assert state.v[0].q.dtype == torch.uint8 and state.v[0].s.shape == (512, 1)
        np.testing.assert_array_equal(state.v[0].q.numpy(), np.asarray(jv["big"]["q"]))
        np.testing.assert_array_equal(state.v[0].s.numpy(), np.asarray(jv["big"]["s"]))
    else:  # v stays in mirrored bfloat16
        assert state.v[0].dtype == torch.bfloat16 and jv["big"].dtype == jnp.bfloat16
    for dtype in ("mirror", "bfloat16", "float32"):  # anything else mirrors, as in JAX
        mirrored = sr_adam.sr_adam_init([torch.zeros(4, 4, dtype=torch.bfloat16)], dtype)
        assert mirrored.m[0].dtype == torch.bfloat16


def _tree(rng, lead=()):
    return {"dense": {"bias": rng.normal(size=(*lead, 8)).astype(np.float32),
                      "kernel": (rng.normal(size=(*lead, 48, 40)) * 0.3).astype(np.float32)},
            "log_var": rng.normal(size=(*lead, 1)).astype(np.float32)}


def _jax_params(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["dense"]["kernel"] = out["dense"]["kernel"].astype(jnp.bfloat16)
    return out


def _port(tree):
    leaves = [torch.from_numpy(np.array(a)) for a in jax.tree.leaves(tree)]
    leaves[1] = leaves[1].to(torch.bfloat16)
    return leaves


def _assert_state_close(p_state, j_state):
    for port_moments, jax_moments in ((p_state.m, j_state[0]), (p_state.v, j_state[1])):
        got = sr_adam.moment_tensors(port_moments)
        want = jax.tree.leaves(jax_moments)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            if g.dtype in (torch.int8, torch.uint8):
                _assert_codes_close(g, w)
            elif g.dtype == torch.bfloat16:
                np.testing.assert_allclose(_np(g), w.astype(np.float32), rtol=2.0 ** -8,
                                           atol=1e-12)
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-12)


def _assert_params_close(p_params, j_params):
    for g, w in zip(p_params, jax.tree.leaves(j_params)):
        rtol = 2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("moment_dtype", ["int8", "int8_m"])
def test_steps_match_jax(moment_dtype):
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    j_params = _jax_params(tree)
    j_state = jax_sr.sr_adam_init(j_params, moment_dtype=moment_dtype)
    p_params = _port(tree)
    p_state = sr_adam.sr_adam_init(p_params, moment_dtype)
    lr, seed = 3e-3, 2**32 - 5
    step_fn = jax.jit(lambda p, s, g, sd: jax_sr.sr_adam_step(p, s, g, jnp.float32(lr), sd))
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.01).astype(np.float32),
                             tree)
        j_grads = jax.tree.map(jnp.asarray, grads)
        j_grads["dense"]["kernel"] = j_grads["dense"]["kernel"].astype(jnp.bfloat16)
        j_params, j_state = step_fn(j_params, j_state, j_grads, jnp.uint32(seed + step))
        p_params, p_state = sr_adam.sr_adam_step(p_params, p_state, _port(grads), lr,
                                                 seed + step)
        _assert_params_close(p_params, j_params)
        _assert_state_close(p_state, j_state)


@pytest.mark.parametrize("moment_dtype", ["int8", "int8_m"])
def test_steps_with_a_trial_axis_match_vmap(moment_dtype):
    K = 3
    rng = np.random.default_rng(4)
    tree = _tree(rng, (K,))
    lrs = np.array([1e-3, 3e-3, 1e-2], np.float32)
    j_params = _jax_params(tree)
    j_state = jax.vmap(lambda p: jax_sr.sr_adam_init(p, moment_dtype=moment_dtype))(j_params)
    p_params = _port(tree)
    p_state = sr_adam.sr_adam_init(p_params, moment_dtype)
    step_fn = jax.jit(jax.vmap(lambda p, s, g, lr, sd: jax_sr.sr_adam_step(p, s, g, lr, sd)))
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.01).astype(np.float32),
                             tree)
        seeds = np.array([11 + step, 2**32 - 1 - step, 400 + step], np.uint32)
        j_grads = jax.tree.map(jnp.asarray, grads)
        j_grads["dense"]["kernel"] = j_grads["dense"]["kernel"].astype(jnp.bfloat16)
        j_params, j_state = step_fn(j_params, j_state, j_grads, jnp.asarray(lrs),
                                    jnp.asarray(seeds))
        p_params, p_state = sr_adam.sr_adam_step(
            p_params, p_state, _port(grads), torch.from_numpy(lrs),
            torch.from_numpy(seeds.astype(np.int64)), trial_axis=True)
        _assert_params_close(p_params, j_params)
        _assert_state_close(p_state, j_state)


def test_int8_tracks_f32_adam():
    """JAX's test: 40 steps of int8-moment SR-Adam stay close to float32 Adam
    relative to the parameter scale."""
    from flexynesis_torch.ops.optim import AdamState, ScaleByAdam, clip_scale

    gen = torch.Generator().manual_seed(0)
    p_ref = torch.randn(1, 256, 256, generator=gen) * 0.1
    p_q = [p_ref[0].to(torch.bfloat16)]
    adam = ScaleByAdam(state_dtype=torch.float32)
    st_ref = adam.init([p_ref])
    st_q = sr_adam.sr_adam_init(p_q, "int8")
    lr = 1e-2
    for t in range(40):
        g = torch.randn(1, 256, 256, generator=gen) * 0.05 + 0.2 * p_ref
        scale = clip_scale([g], 1.0).reshape(-1, 1, 1)
        upd, st_ref = adam.update([g * scale], st_ref)
        gq = g[0] + 0.2 * (p_q[0].float() - p_ref[0])
        p_ref = p_ref - lr * upd[0]
        p_q, st_q = sr_adam.sr_adam_step(p_q, st_q, [gq], lr, 17 + t)
    assert isinstance(st_ref, AdamState)
    diff = (p_q[0].float() - p_ref[0]).abs().mean() / p_ref.std()
    assert float(diff) < 0.08


def test_trial_optimizer_falls_back_to_bf16():
    for name in ("int8", "int8_m"):
        assert trial_optimizer(name).adam.state_dtype == torch.bfloat16


@pytest.fixture(scope="module")
def q8_ds():
    rng = np.random.default_rng(0)
    n, f = 96, 512
    cls = rng.integers(0, 2, n)
    X = (rng.normal(size=(n, f)) + 1.5 * cls[:, None]).astype(np.float32)
    return MultiOmicDataset(dat={"gex": X}, ann={"y": cls.astype(np.float32)},
                            variable_types={"y": "categorical"},
                            features={"gex": [f"g{i}" for i in range(f)]},
                            samples=[f"S{i}" for i in range(n)],
                            label_mappings={"y": {0: "a", 1: "b"}})


Q8_CFG = {"latent_dim": 8, "hidden_dim_factor": 0.5, "lr": 5e-3, "supervisor_hidden_dim": 8,
          "epochs": 10, "batch_size": 32}


def _q8_round(ds, moments, ckpt=None, max_epochs=10, die_after=None, monkeypatch=None):
    model = DirectPred(Q8_CFG, ds, target_variables=["y"], device="cpu")
    if die_after is not None:
        real, seen = trials._Round.validate, {"n": 0}

        def dying(self, batch):
            seen["n"] += 1
            if seen["n"] > die_after:
                raise KeyboardInterrupt("simulated preemption")
            return real(self, batch)

        monkeypatch.setattr(trials._Round, "validate", dying)
    try:
        pt = ParallelTrials(model, ds, moment_dtype=moments,
                            param_dtype="float32" if moments == "float32" else "bfloat16_sr")
        return pt.run(lrs=np.full(2, 5e-3), seeds=np.arange(2), train_idx=np.arange(72),
                      val_idx=np.arange(72, 96), batch_size=32, max_epochs=max_epochs,
                      epochs_per_eval=4 if ckpt else 10, checkpoint_dir=ckpt)
    finally:
        if monkeypatch is not None:
            monkeypatch.undo()


def test_int8_round_converges_like_jax(q8_ds, monkeypatch):
    seen = []
    real_init = sr_adam.sr_adam_init

    def spy(params, moment_dtype="mirror"):
        state = real_init(params, moment_dtype)
        seen.append(state)
        return state

    monkeypatch.setattr(trials, "sr_adam_init", spy)
    int8 = _q8_round(q8_ds, "int8")["best_val_loss"]
    monkeypatch.undo()
    assert any(isinstance(m, sr_adam.Q8) for m in seen[0].m)  # the 512 x 256 kernel
    f32 = _q8_round(q8_ds, "float32")["best_val_loss"]
    assert np.all(np.isfinite(int8))
    assert np.all(int8 < np.maximum(f32 * 1.15, 0.25))


def test_int8_round_resumes_bit_for_bit(q8_ds, tmp_path, capsys, monkeypatch):
    full = _q8_round(q8_ds, "int8", max_epochs=8)
    ckpt = str(tmp_path / "round")
    with pytest.raises(KeyboardInterrupt):
        _q8_round(q8_ds, "int8", ckpt, max_epochs=8, die_after=5, monkeypatch=monkeypatch)
    from flexynesis_torch.train.checkpoint import load_state

    tensors, _ = load_state(os.path.join(ckpt, "round.safetensors"))
    assert any(k.endswith("/q") for k in tensors) and any(k.endswith("/s") for k in tensors)
    resumed = _q8_round(q8_ds, "int8", ckpt, max_epochs=8)
    assert "Resumed trial round from epoch 4" in capsys.readouterr().out
    np.testing.assert_array_equal(resumed["best_val_loss"], full["best_val_loss"])
    for n, t in full["final_params"].items():
        assert torch.equal(resumed["final_params"][n], t), n
