"""The port's dry run (``repro_torch.launch.dryrun`` and ``op_analysis``)
against the same steps run for real, and its records.

The cells of the granite-3-8b and DeepSeek-MoE smoke configs (a train,
a prefill and a decode cell each, cut shapes) and RWKV-6's (prefill and
decode: a decode state with no pool) run on a (data 2, model 2)
mesh, and those of ``GQA_UNEVEN`` (10 query heads in blocks of 3, 3, 3
and 1, whole ``wq``/``wo`` cut to them) on (data 1, model 4), twice,
each in its own processes (``tests/_torch_dryrun_ranks.py``):
on 4 gloo CPU ranks with real tensors, and as rank 0 of a 4-rank fake
process group on meta tensors.  Rank 0's collective calls, bytes and
payload by kind, its FLOPs, HBM bytes and MemTracker's memory peak must
be equal.  (Fake CUDA tensors, the dry run's other mode, cannot be
indexed on a CPU-only torch; ``chip_smoke.py``'s phase 12 (a) runs them
on the card.)  Also: every production cell's inputs, state and record
fields against the reference's functions, the ring factors against the
reference's, ``Traffic``'s bounded sums, the fixed-length cache write,
one production cell of whisper-small on the 256-rank fake mesh with the
reference's record keys, and the param accounting of every full config
on the meta device (the twin of ``tests/test_arch_smoke.py``'s).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _torch_dist_ranks import spawn  # noqa: E402
from _train_mesh_cases import GQA_UNEVEN  # noqa: E402
from repro.launch.hlo_analysis import _wire_factor  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import SHAPES as PRODUCTION_SHAPES  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RANKS = os.path.join(HERE, "_torch_dryrun_ranks.py")
WORLD = 4

#: (smoke config, shape): a train cell of 2 microbatches (B 64 // 32), a
#: prefill and a decode cell
SHAPES = {"train": dict(name="train_smoke", seq_len=16, global_batch=64,
                        kind="train"),
          "prefill": dict(name="prefill_smoke", seq_len=200, global_batch=4,
                          kind="prefill"),
          "decode": dict(name="decode_smoke", seq_len=300, global_batch=4,
                         kind="decode")}
CELLS = {f"{arch}-{kind}": {"arch": arch, "shape": shape}
         for arch in ("granite-3-8b", "deepseek-moe-16b", "rwkv6-7b")
         for kind, shape in SHAPES.items()
         if arch != "rwkv6-7b" or kind != "train"}
CELLS.update({f"gqa-uneven-{kind}": {"arch": "gqa-uneven",
                                     "cfg": GQA_UNEVEN, "mesh": [1, 4],
                                     "shape": shape}
              for kind, shape in SHAPES.items()})

#: the record keys of the reference's dry run that the port keeps
#: (``fits_hbm_80g`` for its ``fits_hbm_16g``; no XLA:CPU artifact)
RECORD_KEYS = {"arch", "shape", "kind", "mesh", "chips", "multi_pod",
               "page_impl", "params", "active_params", "roofline",
               "collectives", "memory", "model_flops", "useful_flops_ratio",
               "tokens_per_step", "fits_hbm_80g", "mesh_axes"}
ROOFLINE_KEYS = {"flops_per_chip", "hbm_bytes_per_chip",
                 "coll_bytes_per_chip", "chips", "compute_s", "memory_s",
                 "collective_s", "bottleneck", "step_s"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dryrun")
    (work / "fake").mkdir()
    for where in (work, work / "fake"):
        (where / "cells.json").write_text(json.dumps(CELLS))
    fake = []
    real = spawn(work, WORLD, "real", script=RANKS, timeout=200,
                 then=lambda: fake.extend(spawn(work / "fake", 1, "fake",
                                                script=RANKS, timeout=200)))
    out = {}
    for mode, logs, where in (("fake", fake, work / "fake"),
                              ("real", real, work)):
        assert [c for c, _ in logs] == [0] * len(logs), "\n".join(
            f"{mode} rank {r} exited {c}:\n{log[-4000:]}"
            for r, (c, log) in enumerate(logs))
        with open(where / f"{mode}.json") as f:
            out[mode] = json.load(f)
    return out


def _record(runs, mode, name):
    res = runs[mode][name]
    assert res["ok"], f"{mode} {name}:\n{res['error']}"
    return res["value"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_fake_cell_equals_the_real_step_on_gloo(runs, name):
    got = _record(runs, "fake", name)
    want = _record(runs, "real", name)
    assert got["collectives"]["calls"] > 0
    assert got["collectives"] == want["collectives"]
    for k in ("flops_per_chip", "hbm_bytes_per_chip", "coll_bytes_per_chip"):
        assert got["roofline"][k] == want["roofline"][k], k
    assert got["memory"] == want["memory"]
    assert got["roofline"]["flops_per_chip"] > 0


def test_cells_use_the_meshes_collectives(runs):
    """Train gathers and reduce-scatters (FSDP); serving from the rank's
    blocks gathers them just in time (and the query heads and logits
    over ``model``) and reduces the SP partials and the tensor-parallel
    sums, with no gradient to reduce-scatter; the MoE train and prefill
    cells route in n_dp groups, the decode cell in one."""
    kinds = {n: set(_record(runs, "fake", n)["collectives"]
                    ["payload_by_kind"]) for n in CELLS}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds[
        "granite-3-8b-train"]
    assert kinds["granite-3-8b-decode"] == {"all-gather", "all-reduce"}
    moe = _record(runs, "fake", "deepseek-moe-16b-train")
    assert moe["moe_groups"] == 2 and moe["microbatches"] == 2
    assert _record(runs, "fake", "deepseek-moe-16b-prefill")[
        "moe_groups"] == 2
    assert _record(runs, "fake", "deepseek-moe-16b-decode")[
        "moe_groups"] == 1


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("n", [1, 2, 4, 16, 512])
def test_wire_factor_matches_reference(kind, n):
    assert coll.wire_factor(kind, n) == _wire_factor(kind, n)


def _reference_dryrun():
    """``repro.launch.dryrun``, whose import asks XLA for 512 host devices:
    the flag is put back, so a JAX backend that starts later in this
    process sees the devices it would have seen."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return ref


#: the production meshes' dims and sizes (``make_production_mesh``)
PRODUCTION = {False: (("data", "model"), (16, 16)),
              True: (("pod", "data", "model"), (2, 16, 16))}


def _specs(specs: dict) -> dict:
    return {k: (tuple(int(n) for n in sh), str(dt).removeprefix("torch."))
            for k, (sh, dt) in specs.items()}


def _ref_specs(specs: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in specs.items()}


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    (a, s, mp) for mp in (False, True) for a, s in dryrun.iter_cells(mp)])
def test_cell_matches_the_reference(arch, shape_name, multi_pod):
    """Every production cell's inputs, state specs and the record's
    fields that the cell fixes (microbatches, MoE groups of train and
    serving cells, decode axes, pool bytes a rank, tokens a step,
    parameter counts) against the reference's ``input_specs``,
    ``state_specs``, constants, sharding rules and configs, on stand-in
    meshes (no process group)."""
    ref = _reference_dryrun()
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.distributed import sharding as jsh
    names, sizes = PRODUCTION[multi_pod]
    jmesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))
    tmesh = SimpleNamespace(mesh_dim_names=names, shape=sizes)
    shape, jcfg = PRODUCTION_SHAPES[shape_name], jget_config(arch)
    B, S = shape.global_batch, shape.seq_len
    assert _specs(dryrun.input_specs(arch, shape_name)) == _ref_specs(
        ref.input_specs(arch, shape_name))
    meta = dryrun.cell_meta(arch, shape, get_config(arch), tmesh,
                            multi_pod=multi_pod)
    assert (meta["params"], meta["active_params"]) == (
        jcfg.param_count(), jcfg.active_param_count())
    assert (meta["mesh"], meta["chips"]) == (list(sizes), math.prod(sizes))
    n_dp = math.prod(jmesh.shape[a] for a in jsh.dp_axes(jmesh))
    # the reference's groups (repro/launch/dryrun.py: n_dp for train and
    # prefill, 1 for decode)
    assert meta["moe_groups"] == (1 if shape.kind == "decode" else n_dp)
    if shape.kind == "train":
        mb = ref.TRAIN_MICROBATCHES.get(arch, max(1, B // 32))
        assert meta["microbatches"] == min(mb, max(1, B // n_dp))
        assert meta["tokens_per_step"] == B * S
        return
    ba, sa = jsh.decode_axes(jmesh, batch=B)
    shards = math.prod(jmesh.shape[a] for a in ba + sa)
    want = ref.state_specs(jcfg, JSHAPES[shape_name], shards)
    assert _specs(dryrun.state_specs(get_config(arch), shape, shards)) == (
        _ref_specs(want))
    pool = sum(math.prod(want[k].shape) * want[k].dtype.itemsize
               for k in ("kv", "mla_c", "mla_rope") if k in want)
    assert meta["pool_bytes_per_chip"] == pool // shards
    assert (meta["batch_axes"], meta["seq_axes"]) == (list(ba), list(sa))
    assert meta["tokens_per_step"] == (B * S if shape.kind == "prefill"
                                       else B)


@pytest.mark.parametrize("shape_name,groups", [
    ("prefill_32k", 16), ("decode_32k", 1), ("train_4k", 16)])
def test_cells_record_the_references_moe_groups(shape_name, groups):
    """A cell records the reference's MoE groups (n_dp = 16 on the pod
    for train and prefill, one for decode) and takes an override."""
    names, sizes = PRODUCTION[False]
    mesh = SimpleNamespace(mesh_dim_names=names, shape=sizes)
    cfg = get_config("deepseek-moe-16b")
    shape = PRODUCTION_SHAPES[shape_name]
    assert dryrun.cell_meta("deepseek-moe-16b", shape, cfg,
                            mesh)["moe_groups"] == groups
    assert dryrun.cell_meta("deepseek-moe-16b", shape, cfg, mesh,
                            moe_groups=4)["moe_groups"] == 4


def test_traffic_sums_stay_bounded():
    """``Traffic`` keeps one entry a kind and group, however many calls."""
    group = object()
    coll._RANKS[group] = (0, 1, 2, 3)
    try:
        t = coll.Traffic()
        for _ in range(1000):
            t.run(lambda: None, 8, torch.device("cpu"), "all-reduce", group)
            t.run(lambda: None, 4, torch.device("cpu"), "all-gather", group)
        assert len(t.groups) == 2 and t.calls == 2000
        assert t.by_kind()["all-reduce"] == {"calls": 1000, "bytes": 8000,
                                             "wire_bytes": 12000.0}
        assert t.wire_bytes == 12000.0 + 3000.0
    finally:
        del coll._RANKS[group]


@pytest.mark.parametrize("k0,k2", [(1, 1), (0, 1), (1, 0), (0, 0)])
def test_drop_write_is_the_masked_write(k0, k2):
    """``layers.drop_write`` leaves the pool as the kept writes alone
    leave it, with dropped entries aimed at a hole, a row past the pool
    and (entry 2, when only entry 0 is kept) a kept entry's cell; every
    duplicate index carries one value, so the order a device applies
    them in cannot matter."""
    g = torch.Generator().manual_seed(0)
    pool = torch.randn(5, 3, 2, generator=g)
    rows = torch.tensor([1, -1, 3, 9])
    offs = torch.tensor([2, 0, 1, 0])
    if k0 and not k2:
        rows[2], offs[2] = rows[0], offs[0]
    keep = torch.tensor([k0, 0, k2, 0], dtype=torch.bool)
    values = torch.randn(4, 2, generator=g)
    want = pool.clone()
    for r in range(4):
        if keep[r]:
            want[rows[r], offs[r]] = values[r]
    where = layers.drop_index((rows, offs), keep)
    with _IndexPuts() as puts:
        got = layers.drop_write(pool.clone(), where, values)
    assert torch.equal(got, want)
    (index, written), = puts.calls
    cells: dict = {}
    for r in range(written.shape[0]):
        cell = tuple(int(i[r]) for i in index)
        assert 0 <= cell[0] < pool.shape[0]
        assert torch.equal(cells.setdefault(cell, written[r]), written[r])


class _IndexPuts(TorchDispatchMode):
    """The (indices, values) of every ``index_put_`` run under it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.index_put_.default,
                    torch.ops.aten._index_put_impl_.default):
            self.calls.append((args[1], args[2]))
        return func(*args, **(kwargs or {}))


def test_production_cell_record(tmp_path):
    """whisper-small × decode_32k on the 256-rank fake mesh, through the
    CLI: the reference's record keys, finite positive terms, the pool
    per rank and a fit."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-small", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads((tmp_path / "whisper-small_decode_32k_sp.json")
                     .read_text())
    assert RECORD_KEYS <= set(rec)
    assert ROOFLINE_KEYS <= set(rec["roofline"])
    assert rec["chips"] == 256 and rec["mesh"] == [16, 16]
    assert rec["batch_axes"] == ["data"] and rec["seq_axes"] == ["model"]
    for k in ("compute_s", "memory_s", "collective_s"):
        assert rec["roofline"][k] > 0
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"] > 0
    assert rec["pool_bytes_per_chip"] > 0 and rec["fits_hbm_80g"]
    assert rec["collectives"]["count_by_kind"]["all-reduce"] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_accounting(arch):
    """The full config's analytic parameter count matches init_params on
    the meta device (no allocation)."""
    cfg = get_config(arch)
    params = tfm.init_params(cfg, generator=None, device="meta",
                             dtype=torch.bfloat16)
    assert tfm.param_count(params) == cfg.param_count()
