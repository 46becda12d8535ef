"""The port's registry against the JAX reference's, and the four
families that arrive last (granite-moe-3b and llama4-maverick, family
``moe``; llava-next-34b, ``vlm``; whisper-tiny, ``encdec``): config and
plan field for field, the ``init_params`` tree and laws (the shared
expert, the projector, the encoder-decoder tree), and the weight
bridge carrying each reference tree bit for bit and refusing a new
leaf of the wrong shape."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import ALIASES as JAX_ALIASES
from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import REGISTRY, get_config
from repro_torch.models.common import init_params
from repro_torch.weights import params_from_jax
from tests.torch_dense_util import (BIAS_LEAVES, SERVE_F32,
                                    one_torch_thread)  # noqa: F401

NAMES = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
         "llava-next-34b", "whisper-tiny"]
# a leaf of each tree that no earlier family had
NEW_LEAF = {"granite-moe-3b-a800m": "blocks/l0/moe/wg",
            "llama4-maverick-400b-a17b": "blocks/l1/moe/shared/wd",
            "llava-next-34b": "projector",
            "whisper-tiny": "dec_blocks/xattn/wq"}


def test_registry_has_every_reference_name():
    assert set(REGISTRY) == set(JAX_REGISTRY)
    for alias, name in JAX_ALIASES.items():
        assert get_config(alias).name == name
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_and_plan_match_reference(name, reduced):
    """Config and plan field for field (the plan's jax.sharding rule
    table excluded), in f32 and at the plan's defaults: on one device
    the MoE plan has no expert axes, for llama4's serving plan too."""
    mine, ref = get_config(name), jax_get_config(name)
    if reduced:
        mine, ref = mine.reduced(), ref.reduced()
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for kw in (SERVE_F32, {}):
        p = dataclasses.asdict(plan_model(mine, None, (1,), "serve", **kw))
        r = dataclasses.asdict(jax_plan_model(ref, None, (1,), "serve",
                                              **kw))
        p.pop("rules")
        r.pop("rules")
        assert p == r
    if mine.moe is not None:
        assert p["moe"]["expert_axes"] == () and p["moe"]["ep"] == 1


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _reference_tree(name):
    jcfg = jax_get_config(name).reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jparams, _ = jax_build_model(jcfg, jplan).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def trees():
    return {name: _reference_tree(name) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_init_matches_reference_tree_and_laws(trees, name):
    """The port's init_params gives the reference's tree: leaf paths,
    shapes and dtypes; biases zero, norm scales one, and the std of
    every leaf of 16384 elements or more (the shared expert's and the
    projector among them) within 5% of the reference's."""
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    mine = dict(_leaves(init_params(cfg, plan, seed=0, device="cpu")))
    ref = dict(_leaves(trees[name]))
    assert set(mine) == set(ref)
    for path, r in ref.items():
        m = mine[path]
        assert tuple(m.shape) == r.shape, path
        assert str(m.dtype).split(".")[-1] == str(r.dtype), path
        leaf = path.split("/")[-1]
        if leaf in BIAS_LEAVES:
            assert not m.any() and not r.any(), path
        elif leaf == "scale":
            assert bool((m == 1).all()) and (r == 1).all(), path
        elif r.size >= 16384:
            rs, ms = float(r.std()), float(m.std())
            assert abs(ms / rs - 1) < 0.05, (path, ms, rs)
    assert NEW_LEAF[name] in mine


@pytest.mark.parametrize("name", NAMES)
def test_bridge_carries_the_tree_and_checks_its_new_leaf(trees, name):
    """Every leaf carried bit for bit; the family's new leaf with the
    wrong shape is refused, and so is a tree without it."""
    tree = trees[name]
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    got = dict(_leaves(params_from_jax(tree, cfg, plan, "cpu")))
    for path, r in _leaves(tree):
        assert torch.equal(got[path], torch.from_numpy(np.array(r))), path
    bad = jax.tree.map(lambda t: t, tree)
    *head, last = NEW_LEAF[name].split("/")
    node = bad
    for k in head:
        node = node[k]
    node[last] = node[last][..., :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, cfg, plan, "cpu")
    del node[last]
    with pytest.raises(ValueError, match="lacks"):
        params_from_jax(bad, cfg, plan, "cpu")


def test_bridge_refuses_another_familys_tree(trees):
    """A granite tree is not llama4's: its leaves have other shapes and
    it lacks the shared expert."""
    cfg = get_config("llama4").reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    with pytest.raises(ValueError):
        params_from_jax(trees["granite-moe-3b-a800m"], cfg, plan, "cpu")
