"""The port's train step against the JAX reference's on the CPU, f32
unless stated: one step's loss, MoE auxiliary loss and every gradient
leaf for each assigned architecture at ``.reduced()`` (biases and
learned positions redrawn non-zero), on the reference's own weights
carried across by ``params_from_jax``.  A pass-through optimizer, whose
``apply`` returns the gradients as the parameters, exposes the
gradients in both packages: AdamW's first step normalizes a gradient
to about its sign, so comparing updated parameters alone would hide a
wrong one.  Then AdamW's update over 3 steps (the clip, the bias
corrections, the decayed set), both schedules at every step,
accumulation 1/2/4 against the full batch, remat "block" against
"none", bf16 compute at 3e-2, and the kernels' refusal of an input
that requires grad.

Tolerances: loss and aux rtol 1e-5; a gradient leaf rtol 1e-4 with
atol 1e-5 x the leaf's largest magnitude (tiny entries of a leaf sum
terms of both signs, so their relative error says nothing); bf16
compute 3e-2, as ``tests/test_kernels.py``.  rwkv6-7b alone gets atol
3e-5 x the leaf's max: its chunked WKV recurrence sums products of
exponentials in another order than the reference's einsums, so its
gradients sit ~5e-6 x max apart, and one entry in 32768 of
``cmix/w_r`` (a value ~1.5e-5 that sums terms of both signs) 1.22e-5 x
max apart, on these inputs (ROADMAP.md section 3); every other
architecture stays within 1.4e-6 x max.

~70 s in one process, most of it the reference's jitted steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import get_config as jax_get_config
from repro.core.steps import build_train_step as jax_build_train_step
from repro.models.registry import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import get_schedule as jax_get_schedule
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core.steps import build_train_step
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW, OptState, get_schedule
from repro_torch.tree import tree_flatten, tree_leaves, tree_map
from repro_torch.weights import params_from_jax
from torch_dense_util import one_torch_thread, perturbed  # noqa: F401

TRAIN_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
B, S = 2, 16


class PassThrough:
    """An optimizer whose update returns the gradients as the
    parameters (either package's step calls ``apply``; the port's
    passes the global norm's ``norm_sq`` too)."""

    def apply(self, params, grads, state, norm_sq=None):
        return grads, state, {}


def train_pair(name, plan_kw=TRAIN_F32):
    """(reference (model, params), port (model, params)) of ``name``'s
    reduced config in train mode on the same perturbed weights."""
    jcfg = jax_get_config(name).reduced()
    jmodel = jax_build_model(jcfg, jax_plan_model(jcfg, None, (1,), "train",
                                                  **plan_kw))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tree = perturbed(jax.tree.map(np.asarray, jparams))
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, None, (1,), "train", **plan_kw)
    model = build_model(cfg, plan, "cpu")
    return ((jmodel, jax.tree.map(jnp.asarray, tree)),
            (model, params_from_jax(tree, cfg, plan, "cpu")))


def make_batch(cfg, rows=B, seed=0, ignored=3):
    """numpy batch: tokens and labels (the first ``ignored`` labels of
    row 0 are -1), whisper's frames, llava's patch embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, S), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (rows, S), dtype=np.int32)
    labels[0, :ignored] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = (0.1 * rng.standard_normal(
            (rows, cfg.encdec.enc_seq, cfg.d_model))).astype(np.float32)
    if cfg.vlm is not None:
        batch["patch_embeds"] = (0.1 * rng.standard_normal(
            (rows, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim))
        ).astype(np.float32)
    return batch


def ref_grads(jmodel, jparams, batch, **kw):
    step, _ = jax_build_train_step(jmodel, PassThrough(), None,
                                   batch["tokens"].shape[0], **kw)
    g, _, m = jax.jit(step)(jparams, None,
                            {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, g), m


def port_grads(model, params, batch, **kw):
    step, _ = build_train_step(model, PassThrough(), None,
                               batch["tokens"].shape[0], **kw)
    g, _, m = step(params, None,
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    return g, m


def _tree_max(tree) -> float:
    return max(_tree_max(v) if isinstance(v, dict) else
               float(np.max(np.abs(np.asarray(v)))) for v in tree.values())


def assert_grads_close(got, want, rtol=1e-4, atol_frac=1e-5, path="",
                       top=None):
    """Leaf by leaf, by key: rtol, atol = atol_frac x the leaf's max.
    A leaf whose reference gradient stays below 1e-6 x the tree's
    largest is the rounding noise of a zero gradient (whisper's key
    biases: without rope a key bias adds one constant to every score of
    a query's row, which its softmax ignores); there the gate is that
    the port's stays below 1e-6 x the tree's largest too."""
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    top = _tree_max(want) if top is None else top
    for k in want:
        if isinstance(want[k], dict):
            assert_grads_close(got[k], want[k], rtol, atol_frac,
                               f"{path}/{k}", top)
            continue
        g = got[k].float().numpy()
        w = np.asarray(want[k], np.float32)
        assert g.shape == w.shape, (f"{path}/{k}", g.shape, w.shape)
        if np.max(np.abs(w)) < 1e-6 * top:
            assert np.max(np.abs(g)) < 1e-6 * top, f"{path}/{k}"
            continue
        scale = float(np.max(np.abs(w))) or 1.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * scale,
                                   err_msg=f"{path}/{k}")


@pytest.mark.parametrize("name", sorted(ASSIGNED))
def test_grads_match_reference(name):
    """One step's loss, aux and gradients equal the reference's."""
    assert sorted(ASSIGNED) == sorted(JAX_ASSIGNED)
    (jmodel, jparams), (model, params) = train_pair(name)
    batch = make_batch(model.cfg)
    jg, jm = ref_grads(jmodel, jparams, batch)
    g, m = port_grads(model, params, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                               rtol=1e-5, atol=1e-7)
    if model.cfg.moe is not None:
        assert float(m["aux"]) > 0
    assert_grads_close(g, jg, atol_frac=3e-5 if name == "rwkv6-7b" else 1e-5)


@pytest.fixture(scope="module")
def smollm():
    return train_pair("smollm-135m")


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_accumulation_matches_full_batch(smollm, accum):
    """accum_steps 1/2/4 over 4 rows with every label counted (each
    microbatch then holds the same count): the loss within 1e-5 of the
    full batch's and the gradients at the stated tolerance.  With
    ignored labels the step averages the microbatches' means, as the
    reference's does: loss and gradients equal to the reference's
    accumulated step."""
    (jmodel, jparams), (model, params) = smollm
    batch = make_batch(model.cfg, rows=4, seed=3, ignored=0)
    full, fm = port_grads(model, params, batch)
    g, m = port_grads(model, params, batch, accum_steps=accum)
    assert abs(float(m["loss"]) - float(fm["loss"])) < 1e-5
    assert_grads_close(g, tree_map(lambda t: t.numpy(), full))
    batch = make_batch(model.cfg, rows=4, seed=3)
    g, m = port_grads(model, params, batch, accum_steps=accum)
    jg, jm = ref_grads(jmodel, jparams, batch, accum_steps=accum)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert_grads_close(g, jg)


@pytest.mark.parametrize("name", ["smollm-135m", "granite-moe-3b-a800m",
                                  "whisper-tiny"])
def test_remat_block_matches_none(name):
    """remat "block" (each super-block, or whisper's decoder layer,
    recomputed in backward) gives the gradients of remat "none" bit for
    bit: the recomputation runs the same ops on the same inputs."""
    (_, _), (model, params) = train_pair(name)
    batch = make_batch(model.cfg)
    g0, m0 = port_grads(model, params, batch)
    cfg = model.cfg
    remat = build_model(cfg, plan_model(cfg, None, (1,), "train",
                                        **dict(TRAIN_F32, remat="block")),
                        "cpu")
    g1, m1 = port_grads(remat, params, batch)
    assert float(m1["loss"]) == float(m0["loss"])
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert torch.equal(a, b)


def test_bf16_compute_matches_reference():
    """compute_dtype bf16 over f32 masters: the loss and every gradient
    leaf within 3e-2 of the reference's bf16 step; the gradients stay
    f32, like the masters."""
    kw = dict(TRAIN_F32, compute_dtype="bfloat16")
    (jmodel, jparams), (model, params) = train_pair("smollm-135m", kw)
    batch = make_batch(model.cfg)
    jg, jm = ref_grads(jmodel, jparams, batch)
    g, m = port_grads(model, params, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=3e-2)
    assert all(t.dtype == torch.float32 for t in tree_leaves(g))
    assert_grads_close(g, jg, rtol=3e-2, atol_frac=3e-2)


def test_adamw_matches_reference_over_three_steps(smollm):
    """AdamW's update with the same gradients for 3 steps: the first
    clipped (norm 40), the second not (norm 0.5), the third with zero
    gradients (decay alone); parameters, moments, step, grad_norm and
    lr within 1e-6 relative of the reference's."""
    (_, jparams), (_, params) = smollm
    params = tree_map(torch.clone, params)
    rng = np.random.default_rng(7)
    shapes = [tuple(p.shape) for p in tree_leaves(params)]
    raw = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    norm = np.sqrt(sum(float(np.sum(np.square(r))) for r in raw))
    jopt = JaxAdamW(lr=jax_get_schedule("cosine", 1e-3, 2, 10))
    opt = AdamW(lr=get_schedule("cosine", 1e-3, 2, 10))
    jstate, state = jopt.init(jparams), opt.init(params)
    jtree = jax.tree_util.tree_structure(jparams)
    for target in (40.0, 0.5, 0.0):
        leaves = [r * np.float32(target / norm) for r in raw]
        jgrads = jax.tree_util.tree_unflatten(
            jtree, [jnp.asarray(x) for x in leaves])
        grads = tree_flatten(params)[1].unflatten(
            [torch.from_numpy(x) for x in leaves])
        jparams, jstate, jm = jax.jit(jopt.apply)(jparams, jgrads, jstate)
        params, state, m = opt.apply(params, grads, state)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=2e-7)
        assert int(state.step) == int(jstate.step)
        for got, want in ((params, jparams), (state.m, jstate.m),
                          (state.v, jstate.v)):
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9)
    assert isinstance(state, OptState) and state.step.dtype == torch.int32


def test_adamw_decays_the_stored_layout_matrices():
    """With zero gradients only decay moves a parameter: every leaf of
    two or more dims, the norm scales stacked (n_sb, D) on the
    super-block axis included (as in the reference), and no vector."""
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, plan_model(cfg, None, (1,), "train",
                                        **TRAIN_F32), "cpu")
    params = model.init(0)
    before = tree_map(torch.clone, params)
    opt = AdamW(lr=lambda step: torch.tensor(1e-2))
    opt.apply(params, tree_map(torch.zeros_like, params), opt.init(params))
    assert params["blocks"]["l0"]["ln1"]["scale"].dim() == 2
    for a, b in zip(tree_leaves(params), tree_leaves(before)):
        assert torch.equal(a, b) == (b.dim() < 2), tuple(b.shape)
    assert torch.equal(params["ln_f"]["scale"], before["ln_f"]["scale"])


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_schedules_match_reference_at_every_step(kind):
    """lr(step) for steps 0..69 of a 60-step run with warmup 3, from a
    Python int and an int32 tensor: float32 values equal to the
    reference's bit for bit on this CPU (a libm cos may round one ulp
    apart on another host; the gate is 1e-7 relative)."""
    j = jax_get_schedule(kind, 6e-4, 3, 60)
    t = get_schedule(kind, 6e-4, 3, 60)
    for s in range(70):
        want = np.float32(j(jnp.int32(s)))
        for arg in (s, torch.tensor(s, dtype=torch.int32)):
            got = t(arg)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-7, atol=0)


def test_kernels_refuse_an_input_that_requires_grad():
    """Each of the six kernel wrappers raises when autograd records and
    an input requires grad (its output would carry no history); the
    same call under no_grad runs (its plain version, on the CPU)."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.gemv.ops import gemv
    from repro_torch.kernels.mamba_scan.ops import (mamba_scan,
                                                    mamba_scan_fused)
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    r = torch.randn
    lens = torch.tensor([3, 5], dtype=torch.int32)
    calls = {
        "gemv": lambda x: gemv(x, r(8, 4)),
        "decode_attention": lambda q: decode_attention(
            q, r(2, 6, 1, 4), r(2, 6, 1, 4), lens),
        "paged_decode_attention": lambda q: paged_decode_attention(
            q, r(3, 4, 1, 4), r(3, 4, 1, 4),
            torch.tensor([[1, 2], [2, 1]], dtype=torch.int32), lens),
        "rwkv_scan": lambda x: rwkv_scan(x, r(1, 3, 2, 4), r(1, 3, 2, 4),
                                         torch.rand(1, 3, 2, 4), r(2, 4),
                                         r(1, 2, 4, 4)),
        "mamba_scan": lambda x: mamba_scan(x, r(1, 3, 5, 2), r(1, 3, 2),
                                           r(1, 5, 2)),
        "mamba_scan_fused": lambda x: mamba_scan_fused(
            x, r(1, 3, 5), -torch.rand(5, 2), r(1, 3, 2), r(1, 3, 2),
            r(1, 5, 2)),
    }
    first = {"gemv": (2, 8), "decode_attention": (2, 2, 4),
             "paged_decode_attention": (2, 2, 4), "rwkv_scan": (1, 3, 2, 4),
             "mamba_scan": (1, 3, 5, 2), "mamba_scan_fused": (1, 3, 5)}
    for name, call in calls.items():
        x = torch.rand(first[name], requires_grad=True)
        with pytest.raises(RuntimeError, match="no backward"):
            call(x)
        with torch.no_grad():
            call(x)
