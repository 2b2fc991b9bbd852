"""Zamba2, RWKV-6 and Whisper through the train step, the checkpoint store
and both launchers: three ``make_train_step`` steps against the reference's
jitted step, checkpoints crossing both packages, the launchers' smoke runs
with crash and resume, ``launch/serve.py --engine float`` with its cache
bytes by key and Whisper's position limit, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import store as jstore
from repro.core.ebops import BetaSchedule as JBeta
from repro.optim.adam import AdamConfig as JAdam
from repro.optim.adam import adam_init as jadam_init
from repro.optim.adam import cosine_restarts as jcosine
from repro.train.steps import TrainHParams as JHP
from repro.train.steps import make_train_step as jmake
from repro_torch import interop
from repro_torch.ckpt import store as tstore
from repro_torch.configs import base as tbase
from repro_torch.core.ebops import BetaSchedule
from repro_torch.models import lm as tlm
from repro_torch.optim.adam import AdamConfig, cosine_restarts
from repro_torch.train.steps import TrainHParams, init_state, make_train_step
from test_torch_lm_models import pair
from test_torch_lm_zoo import ZOO, jb, tb, zbatch

torch.set_num_threads(2)

LR = 1e-3
STEPS = 3
# Each step starts the port from the reference's parameters and Adam state
# (crossed with ``interop.lm_*_from_numpy``): Whisper's smoke model is
# chaotic enough that parameters 2·lr apart at a few entries (ROADMAP C6b)
# move its next gradient norm by 5%.  The metrics within 1e-5 relative,
# the gradient norm within 1e-4; Whisper's within 1e-4 and 1e-2 (its
# activation codes flip between the packages, tests/test_torch_lm_zoo.py;
# seen 1.1e-5 and 1.2e-3).  After each step every parameter entry within
# 2·lr (Adam's first steps are about sign(g)·lr, so an entry whose gradient
# is rounding noise may step the other way) and 99% of each tensor within
# 0.1·lr; Zamba2's 98% (seen 98.7% for w_xz): its float32 gradients move by
# 1e-3 of their largest under a 1e-7 relative change of the parameters (the
# reference's own), so more entries with near-zero gradients step the other
# way; Whisper's 97% (seen 98.4%: 2 of the 128 entries of a norm scale,
# whose gradients its flipped codes move).
METRIC_RTOL = {"zamba2_12b": 1e-5, "rwkv6_16b": 1e-5, "whisper_base": 1e-4}
GNORM_RTOL = {"zamba2_12b": 1e-4, "rwkv6_16b": 1e-4, "whisper_base": 1e-2}
NEAR_SHARE = {"zamba2_12b": 0.98, "rwkv6_16b": 0.99, "whisper_base": 0.97}


@pytest.mark.parametrize("arch", ZOO)
def test_three_steps_against_the_reference(arch):
    """Three AdamW steps (β ramp 1e-6 -> 1e-4 on EBOPs, weight decay,
    clipping, cosine restarts) in float32 on the same batches, each from
    the reference's state: loss, CE, EBOPs, aux loss, learning rate and
    gradient norm, and the parameters after the step, as bounded above."""
    jm, params, tm = pair(arch, "float32")
    jhp = JHP(adam=JAdam(lr=LR, weight_decay=0.01), beta=JBeta(1e-6, 1e-4, STEPS),
              lr_schedule=jcosine(LR, first_period=10, warmup=2))
    thp = TrainHParams(adam=AdamConfig(lr=LR, weight_decay=0.01),
                       beta=BetaSchedule(1e-6, 1e-4, STEPS),
                       lr_schedule=cosine_restarts(LR, first_period=10, warmup=2))
    jstep, _ = jmake(jm, hp=jhp, donate=False)
    tstep, _ = make_train_step(tm, thp)
    jopt = jadam_init(params)
    for s in range(STEPS):
        interop.lm_params_from_numpy(tm, jax.tree.map(np.asarray, params))
        topt = interop.lm_opt_state_from_numpy(tm, jax.tree.map(np.asarray, jopt))
        nb = zbatch(tm.cfg, 2, 32, seed=s)
        params, jopt, jmet = jstep(params, jopt, jb(nb))
        topt, tmet = tstep(topt, tb(nb))
        for k in ("loss", "ce", "ebops", "aux_loss", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=METRIC_RTOL[arch],
                                       err_msg=f"step {s} {k}")
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=GNORM_RTOL[arch], err_msg=f"step {s} grad_norm")
        assert int(topt["step"]) == int(jopt["step"]) == s + 1
        want = interop.unnest(jax.tree.map(np.asarray, params))
        for k, p in tm.flat_params().items():
            d = np.abs(p.detach().numpy() - want[k])
            assert d.max() <= 2 * LR, (s, k, d.max())
            assert np.mean(d <= 1e-4) >= NEAR_SHARE[arch], (s, k, np.mean(d <= 1e-4))


# -------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("arch", ZOO)
def test_checkpoint_shapes_are_the_reference_flatten(arch):
    """``lm_checkpoint_shapes`` of the smoke config equals the reference's
    ``_flatten`` of ``{"params", "opt"}``; at the published widths it
    draws the defs without building the model."""
    jm, params, tm = pair(arch, "float32")
    want = {k: v.shape for k, v in jstore._flatten(
        {"params": params, "opt": jadam_init(params)}).items()}
    assert tlm.lm_checkpoint_shapes(tm.cfg) == want
    full = tlm.lm_checkpoint_shapes(tbase.get_config(arch))
    assert full["opt/step"] == ()
    key, shape = {"zamba2_12b": ("params/shared/wq", (1, 2048, 32, 64)),
                  "rwkv6_16b": ("opt/m/blocks/wr", (24, 2048, 32, 64)),
                  "whisper_base": ("opt/v/dec_pos", (32776, 512))}[arch]
    assert full[key] == shape


@pytest.mark.parametrize("arch", ZOO)
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    _, _, tm = pair(arch, "float32")
    step, _ = make_train_step(tm, TrainHParams(adam=AdamConfig(lr=LR)))
    _, opt = init_state(tm)
    for s in range(2):
        opt, _ = step(opt, tb(zbatch(tm.cfg, 2, 32, seed=s)))
    tstore.CheckpointStore(str(tmp_path)).save(2, tm, opt, extra={"arch": arch}, blocking=True)
    with np.load(tmp_path / "step_0000000002.npz") as z:
        assert {k: z[k].shape for k in z.files} == tlm.lm_checkpoint_shapes(tm.cfg)
    _, params, _ = pair(arch, "float32", seed=5)
    p, o, man = jstore.CheckpointStore(str(tmp_path)).restore(params, jadam_init(params))
    assert man == {"step": 2, "arch": arch} and int(o["step"]) == 2
    for k, t in tm.flat_params().items():
        np.testing.assert_array_equal(interop.unnest(p)[k], t.detach().numpy())
        np.testing.assert_array_equal(interop.unnest(o["m"])[k], opt["m"][k].numpy())
        np.testing.assert_array_equal(interop.unnest(o["v"])[k], opt["v"][k].numpy())


@pytest.mark.parametrize("arch", ZOO)
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    _, params, _ = pair(arch, "float32")
    jopt = jadam_init(params)
    jopt = {"m": jax.tree.map(lambda a: a + 0.25, jopt["m"]), "v": jopt["v"],
            "step": jnp.asarray(7, jnp.int32)}
    jstore.CheckpointStore(str(tmp_path)).save(7, params, jopt, blocking=True)
    _, _, tm = pair(arch, "float32", seed=9)
    _, opt = init_state(tm)
    model, o, man = tstore.CheckpointStore(str(tmp_path)).restore(tm, opt)
    assert model is tm and man["step"] == 7 and int(o["step"]) == 7
    want = interop.unnest(jax.tree.map(np.asarray, params))
    for k, t in tm.flat_params().items():
        np.testing.assert_array_equal(t.detach().numpy(), want[k])
        assert float(o["m"][k].min()) == 0.25
    other = [a for a in ZOO if a != arch][0]
    _, _, wrong = pair(other, "float32")
    with pytest.raises((KeyError, ValueError)):
        tstore.CheckpointStore(str(tmp_path)).restore(wrong)


# ----------------------------------------------------------------- launchers
def _train(argv):
    from repro_torch.launch import train
    return train.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("arch", ZOO)
def test_train_launcher_crash_and_resume_bit_exact(arch, tmp_path):
    """``launch/train.py --smoke``: a straight run of 6 steps, and one that
    crashes after step 3 (exit code 17; in-process, so ``os._exit`` raises
    here) and resumes from its checkpoint: parameters, Adam state and every
    logged metric equal bit for bit; loss - CE = β·EBOPs every step, and
    RWKV-6's EBOPs 0.  Whisper's stub frames are ``make_get_batch``'s
    bf16-rounded values of the reference's shape."""
    from repro_torch.launch import train

    base = ["--arch", arch, "--smoke", "--steps", "6", "--batch", "2", "--seq", "16",
            "--chunk-steps", "2", "--ckpt-every", "2", "--beta-init", "1e-9",
            "--beta-final", "1e-7"]
    straight = _train(base + ["--ckpt-dir", str(tmp_path / "a")])
    met = straight["metrics"]
    beta = BetaSchedule(1e-9, 1e-7, 6)(torch.arange(6)).numpy().astype(np.float64)
    np.testing.assert_allclose(met["loss"], met["ce"] + beta * met["ebops"], rtol=1e-6)
    assert (met["ebops"] == 0).all() == (arch == "rwkv6_16b")

    class Crash(Exception):
        pass

    def fake_exit(code):
        raise Crash(code)

    orig = train.os._exit
    train.os._exit = fake_exit
    try:
        with pytest.raises(Crash) as e:
            _train(base + ["--ckpt-dir", str(tmp_path / "b"), "--simulate-crash", "3"])
        assert e.value.args == (17,)
    finally:
        train.os._exit = orig
    resumed = _train(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert resumed["start"] == 3
    for k, v in resumed["metrics"].items():
        np.testing.assert_array_equal(v, straight["metrics"][k][3:], err_msg=k)
    for k, p in resumed["model"].flat_params().items():
        assert torch.equal(p, straight["model"].get_parameter(k)), k
    for mv in ("m", "v"):
        for k, t in resumed["opt"][mv].items():
            assert torch.equal(t, straight["opt"][mv][k]), (mv, k)
    if arch == "whisper_base":
        import argparse

        get = train.make_get_batch(straight["model"], argparse.Namespace(seq=16, batch=2,
                                                                          seed=0))
        frames, cfg = get(0)["frames"], straight["model"].cfg
        assert frames.shape == (2, cfg.enc_ctx, cfg.d_model)
        assert np.array_equal(frames, torch.as_tensor(frames).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("arch", ZOO)
def test_serve_launcher_float_engine(arch, capsys):
    """``--engine float`` on the CPU: the cache's bytes over every tensor,
    printed by key; B1's plain version on the CPU, so no launch."""
    from repro_torch.launch import serve

    out = serve.main(["--engine", "float", "--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4) and out["b1_per_call"] == [0] * 4
    model = out["model"]
    want = {k: int(np.prod(d.shape)) * torch.empty((), dtype=d.dtype).element_size()
            for k, d in model.cache_defs(2, 20).items() if d.shape}
    if arch == "rwkv6_16b":
        assert set(want) == {"wkv", "shift_t", "shift_c"}
    assert out["cache_bytes"] == want and out["kv_bytes"] == sum(want.values())
    text = capsys.readouterr().out
    assert all(f"{k} {v}" in text for k, v in want.items())


def test_serve_launcher_refuses_whisper_past_its_positions():
    from repro_torch.launch import serve
    from repro_torch.models.whisper import MAX_DEC_POS

    with pytest.raises(SystemExit, match="positions stop at"):
        serve.main(["--engine", "float", "--arch", "whisper_base", "--smoke", "--device", "cpu",
                    "--batch", "1", "--prompt-len", str(MAX_DEC_POS - 2), "--gen", "3"])
