"""The LM train step (``train/steps.py::make_train_step``) against the
reference's jitted step, the train launcher with crash and resume, and the
``train_lm`` example, on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.ebops import BetaSchedule as JBeta
from repro.optim.adam import AdamConfig as JAdam
from repro.optim.adam import adam_init as jadam_init
from repro.optim.adam import cosine_restarts as jcosine
from repro.train.steps import TrainHParams as JHP
from repro.train.steps import make_train_step as jmake
from repro_torch import interop
from repro_torch.core.ebops import BetaSchedule
from repro_torch.optim.adam import AdamConfig, cosine_restarts
from repro_torch.train.steps import TrainHParams, init_state, make_train_step
from test_torch_lm_models import batch, jbatch, pair, tbatch

torch.set_num_threads(2)

LR = 1e-3
STEPS = 3


@pytest.mark.parametrize("arch", ["olmo_1b", "phi35_moe", "internvl2_26b"])
def test_three_steps_against_the_reference(arch):
    """Three AdamW steps (β ramp 1e-6 -> 1e-4 on EBOPs, the MoE aux loss at
    0.01, weight decay, clipping, cosine restarts) in float32 from the same
    parameters and batches.  Every step's loss, CE, EBOPs, aux loss and
    learning rate within 1e-5 relative at step 0, the gradient norm within
    1e-4 (a sum of squares over ~1e5 terms in another order).  Adam's first
    steps are about sign(g)·lr, so an entry whose gradient is rounding noise
    may land up to 2·lr a step away (ROADMAP C6b), and steps 1-2 start from
    parameters that differ so: their metrics within 2e-4 (seen 5e-5), the
    gradient norm within 2e-3 (seen 5.8e-4).  Parameters after the third
    step: every entry within 2·lr·steps, and 99% of each tensor within 1e-4
    (0.1·lr)."""
    jm, params, tm = pair(arch, "float32")
    jhp = JHP(adam=JAdam(lr=LR, weight_decay=0.01), beta=JBeta(1e-6, 1e-4, STEPS),
              lr_schedule=jcosine(LR, first_period=10, warmup=2))
    thp = TrainHParams(adam=AdamConfig(lr=LR, weight_decay=0.01),
                       beta=BetaSchedule(1e-6, 1e-4, STEPS),
                       lr_schedule=cosine_restarts(LR, first_period=10, warmup=2))
    jstep, _ = jmake(jm, hp=jhp, donate=False)
    tstep, _ = make_train_step(tm, thp)
    jopt = jadam_init(params)
    _, topt = init_state(tm)
    for s in range(STEPS):
        nb = batch(tm.cfg, 2, 32, seed=s)
        params, jopt, jmet = jstep(params, jopt, jbatch(nb))
        topt, tmet = tstep(topt, tbatch(nb))
        # step 0 from equal parameters; later steps from parameters that
        # already differ as C6b lets them
        rtol, gtol = (1e-5, 1e-4) if s == 0 else (2e-4, 2e-3)
        for k in ("loss", "ce", "ebops", "aux_loss", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=rtol,
                                       err_msg=f"step {s} {k}")
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=gtol, err_msg=f"step {s} grad_norm")
    assert int(topt["step"]) == int(jopt["step"]) == STEPS
    want = interop.unnest(jax.tree.map(np.asarray, params))
    for k, p in tm.flat_params().items():
        d = np.abs(p.detach().numpy() - want[k])
        assert d.max() <= 2 * LR * STEPS, (k, d.max())
        assert np.mean(d <= 1e-4) >= 0.99, (k, np.mean(d <= 1e-4))


def test_commit_false_writes_nothing():
    _, _, tm = pair("qwen15_05b", "float32")
    step, _ = make_train_step(tm, TrainHParams())
    _, opt = init_state(tm)
    before = {k: p.detach().clone() for k, p in tm.flat_params().items()}
    new_opt, m = step(opt, tbatch(batch(tm.cfg, 2, 32)), commit=False)
    assert int(new_opt["step"]) == 1 and int(opt["step"]) == 0
    for k, p in tm.flat_params().items():
        assert torch.equal(p, before[k]), k
    assert set(m) == {"loss", "ce", "ebops", "aux_loss", "grad_norm", "lr"}


def test_models_from_one_seed_are_equal_and_init_state_is_zero():
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.registry import build_model

    a, b = (build_model(get_smoke("olmo_1b"), device="cpu",
                        generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    params, opt = init_state(a)
    for k, v in params.items():
        assert torch.equal(v, b.get_parameter(k)) and v is a.get_parameter(k)
    assert all(not m.any() for m in opt["m"].values()) and int(opt["step"]) == 0
    # the quantizer widths take the reference's constants
    assert float(params["blocks/gate_qwf"][0]) == 6.0 and float(params["blocks/gate_qai"][0]) == 3.0


# ---------------------------------------------------------------- launcher
def _run(argv):
    from repro_torch.launch import train
    return train.main(argv + ["--device", "cpu"])


def test_train_launcher_crash_and_resume_bit_exact(tmp_path):
    """A straight run, and one that crashes at step 6 (exit code 17) and
    resumes from its checkpoint: parameters, Adam state and every logged
    metric equal bit for bit.  The crash runs in-process here, so the test
    replaces ``os._exit`` with a raise."""
    from repro_torch.launch import train

    base = ["--arch", "olmo_1b", "--smoke", "--steps", "10", "--batch", "2", "--seq", "32",
            "--chunk-steps", "3", "--ckpt-every", "4", "--beta-init", "1e-9",
            "--beta-final", "1e-7"]
    straight = _run(base + ["--ckpt-dir", str(tmp_path / "a")])

    class Crash(Exception):
        pass

    def fake_exit(code):
        raise Crash(code)

    orig = train.os._exit
    train.os._exit = fake_exit
    try:
        with pytest.raises(Crash) as e:
            _run(base + ["--ckpt-dir", str(tmp_path / "b"), "--simulate-crash", "6"])
        assert e.value.args == (17,)
    finally:
        train.os._exit = orig
    resumed = _run(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert resumed["start"] == 6
    for k, v in resumed["metrics"].items():
        np.testing.assert_array_equal(v, straight["metrics"][k][6:], err_msg=k)
    for k, p in resumed["model"].flat_params().items():
        assert torch.equal(p, straight["model"].get_parameter(k)), k
    for mv in ("m", "v"):
        for k, t in resumed["opt"][mv].items():
            assert torch.equal(t, straight["opt"][mv][k]), (mv, k)
    assert int(resumed["opt"]["step"]) == int(straight["opt"]["step"]) == 10


def test_train_launcher_flags():
    from repro_torch.launch import train

    for bad in (["--beta-final", "0"], ["--beta-init", "0", "--beta-final", "1e-3"],
                ["--chunk-steps", "0"]):
        with pytest.raises(SystemExit):
            _run(["--arch", "olmo_1b", "--smoke", "--steps", "2"] + bad)
    args = train.build_argparser().parse_args(["--arch", "olmo_1b", "--beta-final", "1e-3"])
    assert train.resolve_beta(args) == (5e-7, 1e-3)
    assert args.device == "cuda"
    # the SSM family, once refused here, trains: two finite steps of RWKV-6
    out = _run(["--arch", "rwkv6_16b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(out["metrics"]["loss"]) == 2 and np.isfinite(out["metrics"]["loss"]).all()
    assert not out["metrics"]["ebops"].any()


def test_train_launcher_mode():
    """``--mode eager`` is the CPU's default loop, bit for bit; ``--mode
    graph`` needs a card."""
    base = ["--arch", "olmo_1b", "--smoke", "--steps", "4", "--batch", "2", "--seq", "16",
            "--chunk-steps", "2"]
    default, eager = _run(base), _run(base + ["--mode", "eager"])
    for k, v in default["metrics"].items():
        np.testing.assert_array_equal(eager["metrics"][k], v, err_msg=k)
    with pytest.raises(SystemExit, match="--mode graph"):
        _run(base + ["--mode", "graph"])


def test_vlm_launcher_stub_embeddings():
    out = _run(["--arch", "internvl2_26b", "--smoke", "--steps", "3", "--batch", "2",
                "--seq", "16", "--chunk-steps", "2"])
    assert np.isfinite(out["metrics"]["loss"]).all() and len(out["metrics"]["loss"]) == 3


def test_train_lm_example_smoke(tmp_path, capsys):
    from repro_torch.examples import train_lm

    out = train_lm.main(["--smoke", "--steps", "30", "--batch", "4", "--seq", "32",
                         "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["start"] == 0 and out["last"] < out["first"]
    assert "[train_lm]" in capsys.readouterr().out
    assert train_lm.LM100M.quant == "hgq" and train_lm.LM100M.qk_norm
    from repro_torch.models.lm import lm_defs
    from repro_torch.nn.params import count_params
    assert 100e6 < count_params(lm_defs(train_lm.LM100M)) < 110e6
    assert dataclasses.replace(train_lm.SMOKE, name="lm100m") != train_lm.LM100M


@pytest.mark.parametrize("entry", ["train", "serve", "example"])
def test_entry_points_default_to_the_card_and_exit_without_one(entry):
    """``--device`` defaults to ``cuda``; with no card visible (as here) each
    entry point exits instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from repro_torch.examples import train_lm
    from repro_torch.launch import serve, train

    run = {"train": lambda: train.main(["--arch", "olmo_1b", "--smoke", "--steps", "2"]),
           "serve": lambda: serve.main(["--engine", "float", "--arch", "olmo_1b", "--smoke"]),
           "example": lambda: train_lm.main(["--smoke", "--steps", "2"])}[entry]
    with pytest.raises(SystemExit, match="no CUDA device"):
        run()
