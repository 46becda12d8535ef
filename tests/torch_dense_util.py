"""Shared set-up of the port's tests: a reduced config's reference
weights, with every bias and the learned positions redrawn from a seed
(the reference's init gives every bias zeros, so a parity test on its
own weights would never add one), carried across to the port; ``one_torch_thread``, an autouse fixture a
test module imports to run its torch on one thread; and
``reference_compile_cache``, one that turns JAX's persistent compilation
cache on for the module, so the reference engines it builds compile
their identical programs once."""
import jax
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.weights import params_from_jax

SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
SERVE_BF16 = dict(esl_overlap=False, remat="none", compute_dtype="bfloat16",
                  param_dtype="bfloat16")
BIAS_LEAVES = ("bq", "bk", "bv", "bi", "bd", "bias")
BIAS_STD = 0.02


def perturbed(tree, seed: int = 0):
    """numpy tree with every bias leaf drawn from N(0, 0.02^2) and
    ``pos_embed`` redrawn with its init law, std 1/sqrt(max_seq)."""
    rng = np.random.default_rng(seed)

    def walk(t, leaf=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if leaf in BIAS_LEAVES:
            return (rng.standard_normal(t.shape) * BIAS_STD).astype(t.dtype)
        if leaf == "pos_embed":
            std = 1.0 / np.sqrt(t.shape[0])
            return (rng.standard_normal(t.shape) * std).astype(t.dtype)
        return t
    return walk(tree)


def reduced_pair(name: str, plan_kw=SERVE_F32):
    """(reference (cfg, plan, model, jax params), port (cfg, plan, model,
    params)) of ``name``'s reduced config on the same perturbed weights."""
    jcfg = jax_get_config(name).reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **plan_kw)
    jmodel = jax_build_model(jcfg, jplan)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tree = perturbed(jax.tree.map(np.asarray, jparams))
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, None, (1,), "serve", **plan_kw)
    model = build_model(cfg, plan, "cpu")
    params = params_from_jax(tree, cfg, plan, "cpu")
    return ((jcfg, jplan, jmodel, jax.tree.map(jax.numpy.asarray, tree)),
            (cfg, plan, model, params))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the importing module's torch on one thread, restored after
    the module.  The suite's workers each run a torch and an XLA thread
    pool on the same few cores, and there torch's default pool made the
    port's CPU tests several times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reference_compile_cache(tmp_path_factory):
    """Each reference engine jits its programs anew, so every ring of
    every reference fleet compiles the same programs again; with JAX's
    persistent compilation cache on for this module, a program compiled
    once is loaded by the later engines.  The settings are restored
    after the module."""
    from jax._src import compilation_cache
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    old = [getattr(jax.config, k) for k in keys]
    jax.config.update(keys[0], str(tmp_path_factory.mktemp("jax-cache")))
    jax.config.update(keys[1], 0)
    compilation_cache.reset_cache()
    yield
    for k, v in zip(keys, old):
        jax.config.update(k, v)
    compilation_cache.reset_cache()
