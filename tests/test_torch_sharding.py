"""The port's logical-axis resolution against the reference's: every case
of ``tests/test_sharding.py`` resolves to the same spec (the port's spec is
a plain tuple, ``tuple(P)`` of the reference's), the rule tables match, and
the models' and caches' logical-axes tables equal the reference's for the
dense trunk, packed and float.  Resolution reads only axis names and sizes,
so meshes larger than this process's devices are stand-ins on both sides.
"""
import jax
import numpy as np
import pytest
import torch

from repro import sharding as jsh
from repro.configs import get_config as jget_config
from repro.core.qtensor import QTensor as JQTensor
from repro.core.quantizer import QuantConfig as JQuantConfig
from repro.models import build_model as jbuild_model
from repro.serve.kv_cache import PagedKVCache as JPagedKVCache
from repro.serve.quantized import QuantizedModel as JQuantizedModel
from repro.serve.quantized import quantize_lm_packed as jquantize_lm_packed
from repro_torch import sharding as tsh
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantizer import QuantConfig
from repro_torch.launch.row_probe import probe_columns
from repro_torch.models.model import Model
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.quantized import QuantizedModel


class _FakeMesh:
    """Axis names and sizes only (the reference test's stand-in)."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _qt(k=64, n=48, group=32):
    arrays = (np.zeros((k * 4 // 8, n), np.uint8),
              np.zeros((k // group, n), np.float32),
              np.zeros((k // group, n), np.float32))
    return (JQTensor(*arrays, bits=4, group_size=group),
            QTensor(*(torch.from_numpy(a) for a in arrays), 4, group))


_KV4 = ("layers", None, None, "cache_heads", None)
# (function, names, shape(s) or "qt", mesh sizes, rules) of every case of
# the reference's tests/test_sharding.py
CASES = {
    "divisible": ("resolve_spec", ["batch", None, "mlp"], (4, 7, 16),
                  dict(data=1, model=2), {"batch": "data", "mlp": "model"}),
    "drops_nondividing": ("resolve_spec", ["heads"], (7,),
                          dict(data=1, model=2), {"heads": "model"}),
    "tuple_tail": ("resolve_spec", ["batch"], (6,),
                   dict(pod=2, data=2, model=1),
                   {"batch": ("pod", "data")}),
    "axis_not_reused": ("resolve_spec", ["a", "b"], (8, 8),
                        dict(data=1, model=2), {"a": "model", "b": "model"}),
    "joint_drop_and_keep": ("resolve_joint_spec", ["ksplit", None],
                            [[(64, 5), (32, 5), (2, 5)],
                             [(64, 5), (32, 5), (8, 5)]],
                            dict(data=1, model=8), {"ksplit": "model"}),
    "w4_codes_half_width": ("qtensor_spec", ("ksplit", "out"), "qt",
                            dict(data=1, model=8),
                            {"ksplit": "model", "out": "model"}),
    "column_parallel": ("qtensor_spec", (None, "mlp"), "qt",
                        dict(data=2, model=4), "serving"),
    "kv4_scale_pool": ("resolve_spec", _KV4,
                       [(2, 16, 8, 4, 16), (2, 16, 8, 4, 1),
                        (2, 16, 8, 6, 16)], dict(data=2, model=4), "rules"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resolution_equals_reference(case):
    fn, names, shapes, sizes, rules = CASES[case]
    rules = {"serving": tsh.make_serving_rules(),
             "rules": tsh.make_rules()}.get(rules, rules) \
        if isinstance(rules, str) else rules
    mesh = _FakeMesh(**sizes)
    if shapes == "qt":
        jqt, tqt = _qt()
        calls = [((jqt,), (tqt,))]
    elif fn == "resolve_joint_spec":
        calls = [((s,), (s,)) for s in shapes]
    else:
        calls = [((s,), (s,)) for s in (
            shapes if isinstance(shapes, list) else [shapes])]
    for jargs, targs in calls:
        want = getattr(jsh, fn)(names, *jargs, mesh, rules)
        got = getattr(tsh, fn)(names, *targs, mesh, rules)
        assert isinstance(got, tuple) and got == tuple(want), (case, got,
                                                               want)
        # a (names, sizes) pair resolves as the mesh does
        pair = (tuple(sizes), tuple(sizes.values()))
        assert getattr(tsh, fn)(names, *targs, pair, rules) == got


def test_rules_context_and_noop_equal_reference():
    for kw in (dict(multi_pod=True), dict(multi_pod=False, fsdp=False),
               dict(seq_sharding=True)):
        assert tsh.make_rules(**kw) == jsh.make_rules(**kw)
    assert tsh.make_serving_rules() == jsh.make_serving_rules()
    assert tsh.make_serving_rules()["fsdp_embed"] is None
    mesh = _FakeMesh(data=1, model=2)
    with tsh.use_mesh(mesh, tsh.make_rules()):
        assert tsh.current_mesh() is mesh
        assert tsh.current_rules()["mlp"] == "model"
    assert tsh.current_mesh() is None
    x = torch.ones(4, 4)
    assert tsh.shard(x, "batch", None) is x


def test_qtensor_legacy_dict_must_agree():
    _, qt = _qt()
    axes = {"packed": (None, "mlp"), "scale": (None, "mlp"),
            "zp": (None, None)}
    with pytest.raises(ValueError, match="share one logical-axes tuple"):
        tsh.qtensor_spec(axes, qt, _FakeMesh(data=1, model=2),
                         tsh.make_serving_rules())


def _ref_specs(axes, tree, mesh, rules):
    """The reference's tree_shardings walk, resolving with its own
    functions and keeping the specs (its NamedShardings need real
    devices)."""
    if tree is None:
        return None
    if axes is None:
        return jax.tree_util.tree_map(lambda _: (), tree)
    if isinstance(tree, JQTensor):
        s = tuple(jsh.qtensor_spec(axes, tree, mesh, rules))
        return ("qt", s)
    if isinstance(tree, JPagedKVCache):
        return {f: _ref_specs(axes[f], getattr(tree, f), mesh, rules)
                for f in ("k", "v", "page_table", "lens", "k_scale",
                          "v_scale")}
    if isinstance(axes, tuple):
        return tuple(jsh.resolve_spec(axes, tree.shape, mesh, rules))
    return {k: _ref_specs(axes.get(k), v, mesh, rules)
            for k, v in tree.items()}


def _port_specs(specs):
    """The port's spec tree in :func:`_ref_specs`'s form."""
    if specs is None:
        return None
    if isinstance(specs, QTensor):
        assert specs.packed == specs.scale == specs.zp
        return ("qt", specs.packed)
    if isinstance(specs, PagedKVCache):
        return {f: _port_specs(getattr(specs, f)) for f in (
            "k", "v", "page_table", "lens", "k_scale", "v_scale")}
    if isinstance(specs, dict):
        return {k: _port_specs(v) for k, v in specs.items()}
    return specs


def test_tree_shardings_equal_reference():
    """Undeclared subtrees replicate, a QTensor node takes one spec for
    its three leaves, bits and group size kept."""
    jqt, tqt = _qt()
    axes = {"wq": (None, "heads"),
            "w": {"packed": (None, "mlp"), "scale": (None, "mlp"),
                  "zp": (None, "mlp")}}
    mesh, rules = _FakeMesh(data=2, model=4), tsh.make_serving_rules()
    jtree = {"wq": np.zeros((8, 8)), "bk": np.zeros((8,)), "w": jqt,
             "attn_t": {"shift": np.zeros((8,)), "a_inv": np.zeros((8, 8))}}
    ttree = {"wq": torch.zeros(8, 8), "bk": torch.zeros(8), "w": tqt,
             "attn_t": {"shift": torch.zeros(8), "a_inv": torch.zeros(8, 8)}}
    got = tsh.tree_shardings(axes, ttree, mesh, rules)
    assert got["bk"] == got["attn_t"]["shift"] == got["attn_t"]["a_inv"] \
        == ()
    assert (got["w"].bits, got["w"].group_size) == (4, 32)
    assert _port_specs(got) == _ref_specs(axes, jtree, mesh, rules)


def _packed_pair(wbits: int, kv_bits: int, arch: str = "llama-micro"):
    jcfg = jget_config(arch)
    jq = JQuantConfig(w_bits=wbits, a_bits=16, group_size=32, lwc=False,
                      kv_bits=kv_bits)
    jp = jquantize_lm_packed(jbuild_model(jcfg).init(jax.random.PRNGKey(0)),
                             jcfg, jq)
    tq = QuantConfig(w_bits=wbits, a_bits=16, group_size=32,
                     kv_bits=kv_bits)
    return (JQuantizedModel(jcfg, jq, kernel_mode="ref"), jp,
            QuantizedModel(get_config(arch), tq, device="cpu"),
            from_jax_params(jax.tree_util.tree_map(np.asarray, jp)))


@pytest.mark.parametrize("which", ["packed-w4", "packed-w8", "float-llama",
                                   "float-opt"])
def test_param_logical_axes_equal_reference(which):
    """Equal tables, and equal resolved specs on a (2, 2) stand-in under
    the serving rules (the packed trees: each QTensor's joint spec)."""
    mesh, rules = _FakeMesh(data=2, model=2), tsh.make_serving_rules()
    if which.startswith("packed"):
        jm, jp, tm, tp = _packed_pair(int(which[-1]), 8)
    else:
        arch = "llama-micro" if which == "float-llama" else "opt-micro"
        jm = jbuild_model(jget_config(arch))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = Model(get_config(arch), "cpu")
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    axes = tm.param_logical_axes()
    assert axes == jm.param_logical_axes()
    assert _port_specs(tsh.tree_shardings(axes, tp, mesh, rules)) == \
        _ref_specs(jm.param_logical_axes(), jp, mesh, rules)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_cache_logical_axes_equal_reference(kv_bits):
    """Linear and paged caches of the packed model (kv16 also of the float
    model): equal tables and equal specs on a (2, 2) stand-in."""
    jm, _, tm, _ = _packed_pair(4, kv_bits)
    mesh, rules = _FakeMesh(data=2, model=2), tsh.make_rules()
    pairs = [(jm.init_cache(2, 32), tm.init_cache(2, 32)),
             (jm.init_paged_cache(2, 6, 8, 4), tm.init_paged_cache(2, 6, 8, 4))]
    models = [(jm, tm)]
    if kv_bits == 16:
        cfg = get_config("llama-micro")
        models.append((jbuild_model(jget_config("llama-micro")),
                       Model(cfg, "cpu")))
    for jmod, tmod in models:
        for jc, tc in pairs:
            want = jmod.cache_logical_axes(jc)
            got = tmod.cache_logical_axes(tc)
            assert got == want
            assert _port_specs(tsh.tree_shardings(got, tc, mesh, rules)) == \
                _ref_specs(want, jc, mesh, rules)


def test_shard_tree_cuts_equal_blocks_that_reassemble():
    """Each rank's cut of a QTensor (codes, scale and zero points alike)
    and of a vocabulary-split embedding; the cuts in rank order are the
    whole."""
    tm, tp = _packed_pair(4, 8)[2:]
    mesh = (("data", "model"), (1, 2))
    specs = tsh.tree_shardings(tm.param_logical_axes(), tp, mesh,
                               tsh.make_serving_rules())
    shards = [tsh.shard_tree(tp, specs, _Coord(mesh, {"data": 0,
                                                     "model": r}))
              for r in range(2)]
    wq = [s["layers"]["wq"] for s in shards]
    for leaf in ("packed", "scale", "zp"):
        assert torch.equal(torch.cat([getattr(q, leaf) for q in wq], -1),
                           getattr(tp["layers"]["wq"], leaf))
    assert wq[0].d_out == tp["layers"]["wq"].d_out // 2
    assert torch.equal(torch.cat([s["embed"] for s in shards]), tp["embed"])
    wo = [s["layers"]["wo"] for s in shards]
    assert torch.equal(wo[0].packed, wo[1].packed)      # whole K and N


class _Coord:
    """A stand-in mesh with a fixed coordinate."""

    def __init__(self, mesh, coord):
        self.mesh_dim_names, sizes = mesh
        self.mesh = torch.empty(sizes)
        self._coord = coord

    def get_coordinate(self):
        return [self._coord[a] for a in self.mesh_dim_names]


def test_meshes_refuse_a_world_of_another_size():
    """The production meshes need their 256 / 512 ranks, as the
    reference's ``jax.make_mesh`` does; the host mesh takes the world as
    it is (here a world of one, started and torn down by the test)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as meshes
    started = not dist.is_initialized()
    try:
        host = meshes.make_host_mesh(device="cpu")
        assert tsh.axis_sizes(host) == {"data": 1, "model": 1}
        for call, need in ((lambda: meshes.make_production_mesh(
                device="cpu"), 256), (lambda: meshes.make_production_mesh(
                multi_pod=True, device="cpu"), 512),
                (lambda: meshes.make_mesh(2, 2, device="cpu"), 4)):
            with pytest.raises(ValueError, match=f"needs {need} ranks"):
                call()
    finally:
        if started:
            dist.destroy_process_group()


def test_matmul_column_probe_on_the_cpu():
    """launch/row_probe's column mode: at llama-micro's shapes a column
    of ``torch.matmul`` on the CPU is the same bits at N and N / m (the
    float head and linears of this file's meshes)."""
    for k, n in ((128, 384), (384, 128), (128, 512)):
        res = probe_columns(k, n, torch.device("cpu"), rows=4)
        assert all(moved == 0 for moved, _ in res.values()), (k, n, res)
