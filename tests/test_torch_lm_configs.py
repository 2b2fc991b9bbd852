"""The LM zoo's configs, data, registry, int8 compression and checkpoints
(``repro_torch.configs``, ``data/synthetic.lm_batch``, ``models/registry``,
``optim/compress``, ``ckpt/store``) against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import store as jstore
from repro.configs import base as jbase
from repro.data.synthetic import lm_batch as jlm_batch
from repro.optim import compress as jcomp
from repro.optim.adam import adam_init as jadam_init
from repro_torch import interop
from repro_torch.ckpt import store as tstore
from repro_torch.configs import base as tbase
from repro_torch.data.synthetic import lm_batch
from repro_torch.models import lm as tlm
from repro_torch.models.registry import build_model
from repro_torch.optim import compress as tcomp
from repro_torch.train.steps import hparams_from_cfg, init_state, make_train_step
from test_torch_lm_models import batch, pair, tbatch

torch.set_num_threads(2)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    """Every field of the published and the smoke config, all ten archs."""
    assert dataclasses.asdict(tbase.get_config(arch)) == dataclasses.asdict(jbase.get_config(arch))
    assert dataclasses.asdict(tbase.get_smoke(arch)) == dataclasses.asdict(jbase.get_smoke(arch))
    t, j = tbase.get_config(arch), jbase.get_config(arch)
    assert (t.hd, t.sub_quadratic, t.has_decoder) == (j.hd, j.sub_quadratic, j.has_decoder)
    assert tbase.applicable_shapes(t) == jbase.applicable_shapes(j)


def test_tables_equal_the_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS == tbase.list_archs()
    assert tbase.PAPER_TASKS == jbase.PAPER_TASKS
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(tbase.ArchConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ArchConfig)]


@pytest.mark.parametrize("field,value,want", [
    ("REPRO_Q_CHUNK", "64", 64), ("REPRO_REMAT", "0", False), ("REPRO_REMAT", "true", True),
    ("REPRO_CAPACITY_FACTOR", "2.5", 2.5), ("REPRO_DTYPE", "float32", "float32"),
    ("REPRO_LUT_USE_FUSED", "1", True)])
def test_env_overrides(monkeypatch, field, value, want):
    monkeypatch.setenv(field, value)
    name = field[len("REPRO_"):].lower()
    assert getattr(tbase.get_config("olmo_1b"), name) == want
    assert tbase.get_config("olmo_1b") == dataclasses.replace(
        tbase.get_config("olmo_1b"), **{name: want})
    assert getattr(jbase.get_config("olmo_1b"), name) == want
    assert hparams_from_cfg(tbase.get_config("olmo_1b")).lut_use_fused == (
        want if name == "lut_use_fused" else False)


@pytest.mark.parametrize("arch,cls", [("zamba2_12b", "ZambaHybrid"), ("rwkv6_16b", "RWKV6LM"),
                                      ("whisper_base", "WhisperEncDec")])
def test_build_model_raises_for_the_next_slice(arch, cls):
    """The hybrid, SSM and encoder-decoder families, which once raised here
    for the next slice, build their own class (the name is kept from then);
    an unknown family still raises, and no family falls back to another."""
    model = build_model(tbase.get_smoke(arch), device="cpu")
    assert type(model).__name__ == cls and model.cfg.family == tbase.get_smoke(arch).family
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(tbase.get_smoke("olmo_1b"), family="cnn"),
                    device="cpu")


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,b,s,vocab,host,n_hosts", [
    (0, 0, 8, 128, 50304, 0, 1), (3, 17, 4, 33, 256, 1, 2), (1, 5, 6, 64, 32000, 2, 3)])
def test_lm_batch_bit_equal(seed, step, b, s, vocab, host, n_hosts):
    got = lm_batch(seed, step, b, s, vocab, host, n_hosts)
    want = jlm_batch(seed, step, b, s, vocab, host, n_hosts)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_lm_batch_rejects_bad_host_splits():
    with pytest.raises(ValueError):
        lm_batch(0, 0, 5, 8, 10, n_hosts=2)
    with pytest.raises(ValueError):
        lm_batch(0, 0, 4, 8, 10, n_hosts=0)


# ----------------------------------------------------------------- compress
def test_compress_decompress_and_error_feedback():
    """int8 codes equal, scales and residuals within 1 ulp-scale of float32
    (one division and one product a value), over three steps of feedback."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32),
            "b": {"c": rng.normal(0, 1e-3, (11,)).astype(np.float32),
                  "z": np.zeros((3,), np.float32)}}
    jstate = jcomp.ef_init(jax.tree.map(jnp.asarray, tree))
    tstate = tcomp.ef_init(jax.tree.map(torch.as_tensor, tree))
    for step in range(3):
        g = jax.tree.map(lambda a: a * (1 + step), tree)
        jq, js, jstate = jcomp.compress(jax.tree.map(jnp.asarray, g), jstate)
        tq, ts, tstate = tcomp.compress(jax.tree.map(torch.as_tensor, g), tstate)
        for path, want in interop.unnest(jax.tree.map(np.asarray, jq)).items():
            got = interop.unnest(tq)[path]
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), want)
        for a, b in ((ts, js), (tstate, jstate)):
            for path, want in interop.unnest(jax.tree.map(np.asarray, b)).items():
                np.testing.assert_allclose(interop.unnest(a)[path].numpy(), want,
                                           rtol=1e-6, atol=1e-12)
        jd = jcomp.decompress(jq, js)
        td = tcomp.decompress(tq, ts)
        for path, want in interop.unnest(jax.tree.map(np.asarray, jd)).items():
            np.testing.assert_allclose(interop.unnest(td)[path].numpy(), want, rtol=1e-6,
                                       atol=1e-12)


# -------------------------------------------------------------- checkpoints
def test_checkpoint_layout_is_the_reference_flatten():
    """The arrays an LM checkpoint holds, named as the reference's
    ``_flatten`` names them, at the smoke and at the full OLMo-1B widths."""
    jm, params, tm = pair("qwen15_05b", "float32")
    want = {k: v.shape for k, v in jstore._flatten(
        {"params": params, "opt": jadam_init(params)}).items()}
    assert tlm.lm_checkpoint_shapes(tm.cfg) == want
    full = tlm.lm_checkpoint_shapes(tbase.get_config("olmo_1b"))
    assert full["params/blocks/w_gate"] == (16, 2048, 8192)
    assert full["opt/m/embed"] == (50304, 2048) and full["opt/step"] == ()
    assert len(full) == 3 * 20 + 1          # embed, 7 matrices, 12 quantizer widths


def _trained(arch, steps=2):
    _, _, tm = pair(arch, "float32")
    step, _ = make_train_step(tm, hparams_from_cfg(tm.cfg))
    _, opt = init_state(tm)
    for s in range(steps):
        opt, _ = step(opt, tbatch(batch(tm.cfg, 2, 32, seed=s)))
    return tm, opt


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tm, opt = _trained("olmo_1b")
    tstore.CheckpointStore(str(tmp_path)).save(2, tm, opt, extra={"arch": "olmo_1b"},
                                               blocking=True)
    with np.load(tmp_path / "step_0000000002.npz") as z:
        assert {k: z[k].shape for k in z.files} == tlm.lm_checkpoint_shapes(tm.cfg)
    jm, params, _ = pair("olmo_1b", "float32", seed=5)
    p, o, man = jstore.CheckpointStore(str(tmp_path)).restore(params, jadam_init(params))
    assert man == {"step": 2, "arch": "olmo_1b"} and int(o["step"]) == 2
    for k, t in tm.flat_params().items():
        np.testing.assert_array_equal(interop.unnest(p)[k], t.detach().numpy())
        np.testing.assert_array_equal(interop.unnest(o["m"])[k], opt["m"][k].numpy())
        np.testing.assert_array_equal(interop.unnest(o["v"])[k], opt["v"][k].numpy())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jm, params, _ = pair("phi35_moe", "float32")
    jopt = jadam_init(params)
    jopt = {"m": jax.tree.map(lambda a: a + 0.25, jopt["m"]), "v": jopt["v"],
            "step": jnp.asarray(7, jnp.int32)}
    jstore.CheckpointStore(str(tmp_path)).save(7, params, jopt, blocking=True)
    _, _, tm = pair("phi35_moe", "float32", seed=9)
    _, opt = init_state(tm)
    model, o, man = tstore.CheckpointStore(str(tmp_path)).restore(tm, opt)
    assert model is tm and man["step"] == 7 and int(o["step"]) == 7
    want = interop.unnest(jax.tree.map(np.asarray, params))
    for k, t in tm.flat_params().items():
        np.testing.assert_array_equal(t.detach().numpy(), want[k])
        assert float(o["m"][k].min()) == 0.25
    with pytest.raises((KeyError, ValueError)):
        _, _, other = pair("olmo_1b", "float32")
        tstore.CheckpointStore(str(tmp_path)).restore(other)
