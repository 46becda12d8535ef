"""The port's configs and mapper plan against the JAX reference's."""
import dataclasses

import pytest

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.compiler.plan import plan_attention as jax_plan_attention
from repro.compiler.plan import resolve_kv_precision as jax_resolve_kv
from repro.configs import get_config as jax_get_config
from repro_torch.compiler.mapper import plan_model
from repro_torch.compiler.plan import plan_attention, resolve_kv_precision
from repro_torch.configs import get_config

SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")


def _cfg(pkg_get, reduced):
    cfg = pkg_get("smollm-135m")
    return cfg.reduced() if reduced else cfg


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    assert dataclasses.asdict(_cfg(get_config, reduced)) == \
        dataclasses.asdict(_cfg(jax_get_config, reduced))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("mode,kw", [("serve", SERVE_F32), ("serve", {}),
                                     ("train", {})])
def test_plan_model_matches_reference(reduced, mode, kw):
    """Field by field, the rule table (jax.sharding) excluded."""
    mine = dataclasses.asdict(plan_model(_cfg(get_config, reduced), None,
                                         (1,), mode, **kw))
    ref = dataclasses.asdict(jax_plan_model(_cfg(jax_get_config, reduced),
                                            None, (1,), mode, **kw))
    mine.pop("rules")
    ref.pop("rules")
    assert mine == ref


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("heads", [(9, 3, 64), (6, 2, 32), (8, 8, 16),
                                   (12, 4, 32), (4, 1, 32)])
def test_plan_attention_matches_reference(tp, heads):
    mine = plan_attention(*heads, tp)
    ref = jax_plan_attention(*heads, tp)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.block_regular == ref.block_regular
    assert (mine.q_to_kv_local == ref.q_to_kv_local).all()


@pytest.mark.parametrize("knob", ["auto", "float16", "bf16", "fp32", "int8",
                                  "fp8"])
def test_kv_precision_matches_reference(knob):
    mine = resolve_kv_precision(knob, "float32")
    ref = jax_resolve_kv(knob, "float32")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.itemsize == ref.itemsize
    assert mine.bytes_per_row_head(64) == ref.bytes_per_row_head(64)


def test_plan_model_rejects_later_slices():
    """The serving ring and the ``("data", "model")`` grid are planned:
    an MoE's experts over the ring, a giant MoE's over data x model, the
    batch over ``data``, a hybrid's KV sequence over ``data``; training
    on the grid shards the parameters over ``data`` (FSDP); a pod axis
    is a later slice."""
    assert plan_model(get_config("smollm-135m"), ("model",), (2,),
                      "serve").tp == 2
    assert plan_model(get_config("granite"), ("model",), (2,),
                      "serve").moe.expert_axes == ("model",)
    grid = plan_model(get_config("llama4"), ("data", "model"), (2, 2),
                      "serve")
    assert grid.dp_axes == ("data",) and grid.dp == 2
    assert grid.moe.expert_axes == ("data", "model")
    train = plan_model(get_config("smollm-135m"), ("data", "model"), (2, 2),
                       "train")
    assert train.fsdp_axes == ("data",) and train.dp_axes == ("data",)
    assert train.rules["embed"] == ("data",) and train.param_dtype == "float32"
    assert plan_model(get_config("jamba"), ("data", "model"), (2, 2),
                      "serve", kv_seq_axis="data").kv_seq_axis == "data"
    with pytest.raises(NotImplementedError, match="pod"):
        plan_model(get_config("smollm-135m"), ("pod", "data", "model"),
                   (2, 2, 2), "serve")
