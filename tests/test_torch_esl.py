"""The port's ring against the reference's mesh: ``core/rings.py``'s
groups and pairs, ``core/esl.py``'s ``ag_matmul`` / ``rs_matmul`` on 2
and 4 gloo ranks in every mode (overlap and blocking, ``scattered_in``,
``scatter_out``, bias, a 2x2 sub-ring split of 4) against the
reference's under ``shard_map`` on fake devices at 1e-5 in f32,
``sync_bytes_per_token``, the tp plans field for field with their rule
tables, ``init_params`` at a tp plan, and ``shard_params`` bit-equal to
the reference's addressable shards (reduced smollm-135m and opt-1.3b at
tp 2 and 4; smollm's 2 kv heads make tp 4 the duplicated-kv path).

Cost in one process ~30 s: one fake-device subprocess for the
reference (its meshes and inits), two spawns of gloo ranks (tp 2, 4).
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.core import esl as jax_esl
from repro.core import rings as jax_rings
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.core import esl, rings
from repro_torch.core.dist import run_ranks
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.common import init_params
from repro_torch.weights import shard_params
from tests.torch_dense_util import one_torch_thread  # noqa: F401
from tests.torch_tp_util import esl_rank
from tests.util import run_multidevice

F32 = dict(remat="none", compute_dtype="float32", param_dtype="float32")
NAMES = ("smollm-135m", "opt-1.3b")
DENSE = ("smollm-135m", "opt-1.3b", "opt-6.7b", "gpt3-20b", "qwen1.5-4b",
         "deepseek-coder-33b", "minicpm-2b")


# ---------------------------------------------------------------------------
# cases: per-rank locals stacked on a leading rank axis
# ---------------------------------------------------------------------------

def _cases(n: int):
    rng = np.random.default_rng(10 + n)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def case(op, tp, overlap, sub=None, bias=True, **kw):
        if op == "ag":
            si = kw.get("scattered_in")
            d = 8 if (overlap if si is None else si) else 8 * tp
            x, w = rnd(n, 3, d), rnd(n, 8 * tp, 5)
            b = rnd(n, 5) if bias else None
        else:
            x, w = rnd(n, 3, 6), rnd(n, 6, 4 * tp)
            b = np.repeat(rnd(1, 4 * tp), n, 0) if bias else None
        return dict(op=op, tp=tp, overlap=overlap, ring=sub, x=x, w=w, b=b,
                    scattered_in=kw.get("scattered_in"),
                    scatter_out=kw.get("scatter_out", True))

    out = []
    for overlap in (True, False):
        for si in (None, True, False):
            out.append(case("ag", n, overlap, scattered_in=si))
        out.append(case("ag", n, overlap, bias=False))
        for so in (True, False):
            out.append(case("rs", n, overlap, scatter_out=so))
            out.append(case("rs", n, overlap, scatter_out=so, bias=False))
    if n == 4:
        for overlap in (True, False):
            out.append(case("ag", 2, overlap, sub=(4, 2)))
            for so in (True, False):
                out.append(case("rs", 2, overlap, sub=(4, 2),
                                scatter_out=so))
    return out


REFERENCE = """
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import esl
from repro.core.rings import RingConfig
from repro.core.compat import make_mesh, shard_map
from repro.compiler.mapper import plan_model
from repro.configs import get_config
from repro.models.registry import build_model

data = dict(np.load(PATH_IN, allow_pickle=True))
out = {}
for n in (2, 4):
    # every case of a ring in ONE shard_map program (one compile)
    keys = sorted(k for k in data if k.startswith(f'case|{n}|'))
    cs = [data[k].item() for k in keys]
    mesh = make_mesh((n,), ('model',), devices=jax.devices()[:n])
    args = []
    for c in cs:
        b = c['b'] if c['b'] is not None else np.zeros((n, 1), np.float32)
        args += [c['x'], c['w'], b]

    def f(*a, cs=cs):
        ys = []
        for i, c in enumerate(cs):
            x, w, b = a[3 * i][0], a[3 * i + 1][0], a[3 * i + 2][0]
            bb = b if c['b'] is not None else None
            ring = RingConfig(*c['ring']) if c['ring'] else None
            if c['op'] == 'ag':
                y = esl.ag_matmul(x, w, axis='model', tp=c['tp'],
                                  overlap=c['overlap'],
                                  scattered_in=c['scattered_in'], b=bb,
                                  ring=ring)
            else:
                y = esl.rs_matmul(x, w, axis='model', tp=c['tp'],
                                  overlap=c['overlap'],
                                  scatter_out=c['scatter_out'], b=bb,
                                  ring=ring)
            ys.append(y[None])
        return tuple(ys)
    ys = jax.jit(shard_map(f, mesh=mesh,
                           in_specs=(P('model'),) * len(args),
                           out_specs=(P('model'),) * len(cs),
                           check_vma=False))(*args)
    for k, y in zip(keys, ys):
        out[k] = np.asarray(y)

def walk(t, pre=''):
    for k, v in t.items():
        p = f'{pre}/{k}' if pre else k
        if isinstance(v, dict):
            yield from walk(v, p)
        else:
            yield p, v

for name in NAMES:
    for tp in (2, 4):
        cfg = get_config(name).reduced()
        plan = plan_model(cfg, ('model',), (tp,), 'serve', esl_overlap=True,
                          remat='none', compute_dtype='float32',
                          param_dtype='float32')
        model = build_model(cfg, plan)
        params, _ = model.init(jax.random.PRNGKey(0))
        specs, _ = model.param_specs()
        devs = list(jax.devices()[:tp])
        mesh = make_mesh((tp,), ('model',), devices=devs)
        placed = jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P)))
        for path, leaf in walk(placed):
            out[f'tree|{name}|{tp}|full|{path}'] = np.asarray(leaf)
            for sh in leaf.addressable_shards:
                r = devs.index(sh.device)
                out[f'tree|{name}|{tp}|{r}|{path}'] = np.asarray(sh.data)
np.savez(PATH_OUT, **out)
print('DONE')
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's ESL outputs of every case on 2 and 4 fake devices,
    and its trees at the tp plans with every rank's addressable shard,
    from one fake-device subprocess."""
    cases = {2: _cases(2), 4: _cases(4)}
    with tempfile.TemporaryDirectory() as d:
        pin, pout = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(pin, **{f"case|{n}|{i:02d}": np.asarray(c, dtype=object)
                         for n, cs in cases.items()
                         for i, c in enumerate(cs)})
        body = (f"PATH_IN, PATH_OUT, NAMES = {pin!r}, {pout!r}, {NAMES!r}\n"
                + REFERENCE)
        assert "DONE" in run_multidevice(body, n_devices=4, timeout=900)
        ref = dict(np.load(pout))
    return cases, ref


@pytest.fixture(scope="module")
def port_esl(reference):
    cases, _ = reference
    return {n: run_ranks(esl_rank, n, cases[n], device="cpu", threads=1)
            for n in (2, 4)}


# ---------------------------------------------------------------------------
# rings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,size", [(8, 2), (8, 4), (4, 2), (4, 4),
                                        (2, 1), (8, 8)])
def test_ring_config_matches_reference(total, size):
    mine, ref = rings.reconfigure(total, size), jax_rings.reconfigure(total,
                                                                      size)
    assert mine.n_rings == ref.n_rings
    assert mine.groups() == ref.groups()
    assert rings.rank_groups(total, size) == ref.groups()
    assert make_serving_mesh(size, total // size).groups() == ref.groups()
    for up in (True, False):
        assert mine.perm_within_rings(up) == ref.perm_within_rings(up)
    assert [mine.ring_of(i) for i in range(total)] == \
        [ref.ring_of(i) for i in range(total)]
    assert mine.validate_disjoint() and ref.validate_disjoint()
    with pytest.raises(ValueError):
        rings.RingConfig(total, size + 1 if total % (size + 1) else 3)


@pytest.mark.parametrize("d_model,tp", [(2048, 2), (2048, 4), (576, 8),
                                        (7168, 1)])
@pytest.mark.parametrize("overlap", [True, False])
def test_sync_bytes_per_token_matches_reference(d_model, tp, overlap):
    for nbytes in (2, 4):
        assert esl.sync_bytes_per_token(d_model, tp, nbytes, overlap) == \
            jax_esl.sync_bytes_per_token(d_model, tp, nbytes, overlap)


# ---------------------------------------------------------------------------
# the collective matmuls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_esl_matmuls_match_reference(reference, port_esl, n):
    """Every mode's per-rank output equals the reference's shard_map
    output at 1e-5, rank by rank."""
    cases, ref = reference
    per_rank = port_esl[n]
    for i, c in enumerate(cases[n]):
        want = ref[f"case|{n}|{i:02d}"]
        for r in range(n):
            np.testing.assert_allclose(
                per_rank[r][0][i], want[r], rtol=1e-5, atol=1e-5,
                err_msg=f"case {i} ({c['op']}, overlap={c['overlap']}, "
                        f"ring={c['ring']}) rank {r}")


@pytest.mark.parametrize("n", [2, 4])
def test_ring_collectives_and_helpers(port_esl, n):
    """gather/scatter/full_vec, psum/pmax/pmean/psum_scatter and a
    ppermute with one pair, against numpy; the overlap mode's matmuls
    ran their hops as ppermutes, the blocking ones none."""
    per_rank = port_esl[n]
    vs = [np.arange(8, dtype=np.float32) + 10 * r for r in range(n)]
    c = 8 // n
    for r in range(n):
        h = per_rank[r][1]
        np.testing.assert_array_equal(h["gather"], np.concatenate(vs))
        np.testing.assert_array_equal(h["full_vec"], np.concatenate(vs))
        np.testing.assert_array_equal(h["scatter"], vs[r][r * c:(r + 1) * c])
        np.testing.assert_allclose(h["psum"], sum(vs), rtol=1e-6)
        np.testing.assert_array_equal(h["pmax"], vs[-1])
        np.testing.assert_allclose(h["pmean"], sum(vs) / n, rtol=1e-6)
        np.testing.assert_allclose(h["psum_scatter"],
                                   sum(vs)[r * c:(r + 1) * c], rtol=1e-6)
        want = vs[0] if r == 1 else np.zeros(8, np.float32)
        np.testing.assert_array_equal(h["ppermute"], want)
        assert h["counters"]["hops"] > 0
        assert h["counters"]["staged_bytes"] == 0      # the CPU stages none
        (c0, f0), (c1, f1), (c2, f2), (c3, f3) = h["param_gathers"]
        ps = [np.arange(4, dtype=np.float32) + 10 * q for q in range(n)]
        np.testing.assert_array_equal(f0, np.concatenate(ps))
        np.testing.assert_array_equal(f2, np.concatenate(ps) + 1)
        assert c1 == c0 and c2 == c1 + 1 and c3 == c2    # once per version
        assert h["sample_sharded"] == 5


# ---------------------------------------------------------------------------
# plans, init and shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("overlap", [True, False])
def test_tp_plan_matches_reference(name, tp, overlap):
    axes, shape = ("model",), (tp,)
    for reduced in (False, True):
        cfg, jcfg = get_config(name), jax_get_config(name)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        mine = plan_model(cfg, axes, shape, "serve", esl_overlap=overlap,
                          **F32)
        ref = jax_plan_model(jcfg, axes, shape, "serve",
                             esl_overlap=overlap, **F32)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.rules == ref.rules and mine.rules
        assert (mine.attn.q_to_kv_local == ref.attn.q_to_kv_local).all()
        assert mine.attn.block_regular == ref.attn.block_regular


def _leaves(tree, pre=""):
    for k, v in tree.items():
        p = f"{pre}/{k}" if pre else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def _ref_tree(ref, name, tp, which):
    pre = f"tree|{name}|{tp}|{which}|"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _plan(name, tp):
    return plan_model(get_config(name).reduced(), ("model",), (tp,), "serve",
                      esl_overlap=True, **F32)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("tp", [2, 4])
def test_init_params_at_tp_plan_matches_reference_layout(reference, name,
                                                         tp):
    """The port's init at a tp plan gives the reference's tree at that
    plan: paths, shapes and dtypes; the zero heads (pad q heads in wq
    and wo) exactly where the reference's are; duplicated kv heads equal
    copies in both; the std of every leaf of 16384 elements or more
    within 5% of the reference's.  (The numbers come from another
    generator, so they are not the reference's.)"""
    _, ref = reference
    plan = _plan(name, tp)
    mine = {p: t.numpy() for p, t in _leaves(init_params(
        get_config(name).reduced(), plan, seed=0, device="cpu"))}
    full = _ref_tree(ref, name, tp, "full")
    assert set(mine) == set(full)
    a = plan.attn
    for path, r in full.items():
        m = mine[path]
        assert m.shape == r.shape and m.dtype == r.dtype, path
        leaf = path.split("/")[-1]
        if leaf in ("wq", "wo"):
            ax = 2 if leaf == "wq" else 1
            zm = ~m.any(axis=tuple(i for i in range(m.ndim) if i != ax))
            zr = ~r.any(axis=tuple(i for i in range(r.ndim) if i != ax))
            np.testing.assert_array_equal(zm, zr, err_msg=path)
            np.testing.assert_array_equal(zm, np.asarray(a.q_orig) < 0)
        if leaf in ("wk", "wv"):
            for t in (m, r):
                for c, o in enumerate(a.kv_orig):
                    first = a.kv_orig.index(o)
                    np.testing.assert_array_equal(t[..., c, :],
                                                  t[..., first, :])
        if r.size >= 16384 and leaf not in ("wq", "wo", "wk", "wv"):
            assert abs(float(m.std()) / float(r.std()) - 1) < 0.05, path
    if a.dup > 1:
        assert len(set(a.kv_orig)) < len(a.kv_orig)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_bit_equal_to_reference_shards(reference, name, tp):
    """shard_params(the reference's full tree, plan, rank) is, leaf for
    leaf, the reference's addressable shard on device ``rank`` of its
    NamedSharding over the model mesh: numpy and torch leaves alike."""
    _, ref = reference
    plan = _plan(name, tp)
    full = _ref_tree(ref, name, tp, "full")
    nested = {}
    for path, v in full.items():
        node = nested
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    for r in range(tp):
        want = _ref_tree(ref, name, tp, str(r))
        got = dict(_leaves(shard_params(nested, plan, r)))
        got_t = dict(_leaves(shard_params(_to_torch(nested), plan, r)))
        assert set(got) == set(want) == set(got_t)
        for path, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[path]), w,
                                          err_msg=f"{path} rank {r}")
            np.testing.assert_array_equal(got_t[path].numpy(), w)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def test_shard_params_refuses_other_families():
    """An encoder-decoder's leaves shard by their rules too (whisper's
    ``enc_blocks``, ``dec_blocks`` with ``lnx`` and ``xattn``,
    ``ln_enc``): each rank holds its heads, FFN columns, vocab rows and
    ``embed_scatter`` columns, and the ranks' blocks put back together
    are the tree; a leaf of no family and a plan off the ring are
    refused."""
    cfg = get_config("whisper-tiny").reduced()
    plan = plan_model(cfg, ("model",), (2,), "serve", **F32)
    full = init_params(cfg, plan, 0, "cpu")
    shards = [dict(_leaves(shard_params(full, plan, r))) for r in (0, 1)]
    split = {"dec_blocks/xattn/wq": 2, "dec_blocks/xattn/wo": 1,
             "enc_blocks/mlp/wi": 2, "dec_blocks/lnx/scale": 1,
             "ln_enc/scale": 0, "pos_embed": 1, "embed": 0}
    for path, t in _leaves(full):
        d = split.get(path)
        if d is not None:
            assert torch.equal(torch.cat([s[path] for s in shards], d), t)
    a = plan.attn
    assert shards[1]["dec_blocks/xattn/wk"].shape == (
        cfg.n_layers, cfg.d_model, a.kv_per_rank, a.d_head)
    with pytest.raises(ValueError, match="no logical axes"):
        shard_params({"enc_blocks": {"conv": {"w": torch.zeros(2, 2)}}},
                     plan, 0)
    with pytest.raises(ValueError, match="ring"):
        shard_params({}, plan_model(cfg, None, (1,), "serve", **F32), 0)
