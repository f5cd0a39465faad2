"""The port's sharding rules against the reference's, entry by entry: every
leaf of every smoke config's params, the decode layout and state specs,
the batch and token specs, on stand-in meshes (data 4, model 2) and
(pod 2, data 4, model 2), and the training collectives' block layout
against a block-by-block loop.  The rules read only dim names
and sizes, so a stand-in needs ``axis_names`` and ``shape`` on the JAX
side and ``mesh_dim_names`` and ``shape`` on the port's; no process
starts."""

from __future__ import annotations

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec

torch = pytest.importorskip("torch")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_smoke as jsmoke  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.bridge import map_leaves  # noqa: E402
from repro_torch.configs import get_smoke as tsmoke  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

MESHES = {"data4_model2": (("data", "model"), (4, 2)),
          "pod2_data4_model2": (("pod", "data", "model"), (2, 4, 2))}


def meshes(name):
    names, shape = MESHES[name]
    return (SimpleNamespace(axis_names=names, shape=dict(zip(names, shape))),
            SimpleNamespace(mesh_dim_names=names, shape=shape))


def _ref_flat(specs) -> dict:
    """{checkpoint-style key: spec entries} of the reference's spec tree."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(spec)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    jmesh, tmesh = meshes(mesh)
    jcfg, tcfg = jsmoke(arch), tsmoke(arch)
    shapes = jax.eval_shape(
        lambda: jtfm.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    want = _ref_flat(jsh.param_specs(shapes, jmesh))
    params = ttfm.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    got: dict = {}
    # a spec is a tuple: walk the params, with the specs beside them
    map_leaves(lambda key, _b, _x, spec: got.setdefault(key, set()).add(
        tuple(spec)), params, tsh.param_specs(params, tmesh))
    assert set(got) == set(want)
    for key, specs in got.items():
        assert specs == {want[key]}, key
    # every spec becomes DTensor placements (a body block drops the stack
    # entry), with as many entries as the mesh has dims
    placed = tsh.param_placements(params, tmesh)
    map_leaves(lambda key, _b, _x, pl: len(pl) == len(tmesh.shape) or
               pytest.fail(key), params, placed)


@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decode_layout_and_state_specs_match_reference(mesh, batch):
    jmesh, tmesh = meshes(mesh)
    axes = tsh.decode_axes(tmesh, batch=batch)
    assert axes == jsh.decode_axes(jmesh, batch=batch)
    cfg = jsmoke("jamba-v0.1-52b")
    want = jsh.decode_state_specs(cfg, jmesh, batch_axes=axes[0],
                                  seq_axes=axes[1])
    got = tsh.decode_state_specs(tsmoke("jamba-v0.1-52b"), tmesh,
                                 batch_axes=axes[0], seq_axes=axes[1])
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}
    state = {"kv": None, "tables": None, "lengths": None}
    assert tsh.filter_state_specs(got, state) == {
        k: tuple(v) for k, v in jsh.filter_state_specs(want, state).items()}


@pytest.mark.parametrize("inputs", [{}, {"has_patches": True},
                                    {"has_frames": True}])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_token_specs_match_reference(mesh, inputs):
    jmesh, tmesh = meshes(mesh)
    got = tsh.batch_specs(tmesh, **inputs)
    want = jsh.batch_specs(jmesh, **inputs)
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}
    for shard in (True, False):
        assert tuple(tsh.tokens_spec(tmesh, shard_batch=shard)) == tuple(
            jsh.tokens_spec(jmesh, shard_batch=shard))
    assert tsh.dp_axes(tmesh) == jsh.dp_axes(jmesh)
    assert tsh.fsdp_spec_axes(tmesh) == jsh.fsdp_spec_axes(jmesh)


def test_to_placements_splits_in_mesh_dim_order():
    """One entry per mesh dim; a dim over ("data", "model") is Shard on
    both (DTensor then splits it row-major, which the multi-process test
    pins), and a split listed out of the mesh's order is refused."""
    _, tmesh = meshes("pod2_data4_model2")
    P = tsh.P
    assert tsh.to_placements(P(("pod", "data"), "model"), tmesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert tsh.to_placements(P(None, "data"), tmesh) == [
        Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        tsh.to_placements(P(("model", "data"), None), tmesh)
    with pytest.raises(ValueError, match="twice"):
        tsh.to_placements(P("data", "data"), tmesh)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_ranks(multi_pod):
    """(16, 16) or (2, 16, 16) ranks, as the reference's mesh needs as
    many devices; this process is one rank, so both refuse."""
    from repro_torch.launch import mesh as tmesh
    n = 512 if multi_pod else 256
    with pytest.raises(RuntimeError, match=f"need {n} ranks"):
        tmesh.make_production_mesh(multi_pod=multi_pod)
    assert tmesh.axis_sizes(meshes("pod2_data4_model2")[1]) == {
        "pod": 2, "data": 4, "model": 2}


@pytest.mark.parametrize("page_impl,mesh", [("sp", None), ("sp_opt", None),
                                            ("ref", "mesh"),
                                            ("kernel", "mesh")])
def test_decode_step_pairs_sp_with_a_mesh(page_impl, mesh):
    """On a mesh the pools are the rank's shards, which only the SP impls
    read; off one, the SP impls have nothing to combine over."""
    cfg = tsmoke("granite-3-8b")
    params = ttfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    st = ttfm.init_decode_state(cfg, 2, 256, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        ttfm.decode_step(params, cfg, st, torch.zeros(2, dtype=torch.int32),
                         page_impl=page_impl,
                         mesh=None if mesh is None else object())


@pytest.mark.parametrize("shape,spec,axes", [
    ((8, 6), ("data", "model"), ("data", "model")),
    ((16, 3), (("data", "model"), None), ("data", "model")),
    ((4, 8, 6), ("model", ("pod", "data"), None), ("pod", "data", "model")),
    ((8, 6), ("data", "model"), ("data",)),
    ((61, 8), ("model", "data"), ("data", "model")),     # a short last block
    ((10, 3), (("pod", "data"), None), ("pod", "data")),  # short inner blocks
    ((3, 5), ("data", "model"), ("model", "data")),       # an empty block
])
def test_block_layout_matches_the_block_loop(shape, spec, axes):
    """The buffer layout the training collectives move
    (``collectives._block_layout``: padded, permuted, then the padding
    dropped) puts each member's block where a block-by-block loop over
    ``block_of`` puts it, padded to the first block, both ways."""
    from repro_torch.distributed import collectives as coll
    _, tmesh = meshes("pod2_data4_model2")
    spec = tsh.P(*spec)
    whole = torch.arange(1, math.prod(shape) + 1).reshape(shape)
    n = coll.axis_size(tmesh, axes)
    chunk = coll._chunk_shape(shape, spec, tmesh, axes)
    loop = torch.zeros((n,) + chunk, dtype=whole.dtype)
    for p in range(n):
        blk = tsh.block_of(shape, spec, tmesh,
                           coll._coordinates(tmesh, axes, p), axes)
        loop[p][tuple(slice(0, s.stop - s.start) for s in blk)] = whole[blk]
    unfolded, perm, padded, real = coll._block_layout(shape, spec, tmesh,
                                                      axes)
    grown = whole
    for d, idx in real.items():
        size = list(grown.shape)
        size[d] = padded[d]
        grown = grown.new_zeros(size).index_copy_(d, torch.tensor(idx),
                                                  grown)
    stacked = grown.reshape(unfolded).permute(perm).reshape(loop.shape)
    assert torch.equal(stacked, loop)
    back = stacked.reshape([unfolded[i] for i in perm]).permute(
        [perm.index(i) for i in range(len(perm))]).reshape(padded)
    for d, idx in real.items():
        back = back.index_select(d, torch.tensor(idx))
    assert torch.equal(back, whole)
    assert (set(real) == set()) == (math.prod(chunk) * n
                                    == math.prod(shape))
