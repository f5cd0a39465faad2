"""The port's package boundary: the host-side control plane is a verbatim
copy of the reference's NumPy-only modules (imports renamed), and nothing
in ``repro_torch`` imports JAX or the reference package."""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

#: the reference modules the port copies verbatim (imports renamed)
COPIED = (["models/config.py", "serving/scheduler.py", "serving/sim.py",
           "training/data.py"]
          + [f"core/{m}.py" for m in (
              "__init__", "tracking", "events", "config", "contexts",
              "block_table", "allocator", "prefix", "metrics", "shootdown",
              "topology", "fpr", "eviction", "tracing", "export")]
          + sorted(str(p.relative_to(REF))
                   for d in ("configs", "serving/admission")
                   for p in (REF / d).glob("*.py")))


@pytest.mark.parametrize("module", COPIED)
def test_host_module_is_a_verbatim_copy(module):
    want = re.sub(r"\brepro\.", "repro_torch.", (REF / module).read_text())
    assert (PORT / module).read_text() == want, (
        f"src/repro_torch/{module} drifted from src/repro/{module}")


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|repro)(?:[.\s]|$)",
                     re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PORT)) for p in PORT.rglob("*.py")))
def test_port_source_imports_no_jax_and_no_reference(path):
    hits = _IMPORT.findall((PORT / path).read_text())
    assert not hits, f"{path} imports {hits}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + str(p.relative_to(PORT).with_suffix("")).replace(
            os.sep, ".").removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    # the slices: GQA paged attention, MLA + MoE, Mamba, RWKV-6 and flash
    # attention
    assert {"repro_torch.models.mla", "repro_torch.models.moe",
            "repro_torch.models.mamba", "repro_torch.models.rwkv6",
            "repro_torch.kernels.paged_attention.ops"} <= set(mods)
    assert {f"repro_torch.kernels.{k}.{m}"
            for k in ("mla_attention", "mamba_scan", "rwkv6_scan",
                      "flash_attention")
            for m in (k, "ops", "ref")} <= set(mods)
    # the training slice
    assert {f"repro_torch.training.{m}"
            for m in ("data", "optimizer", "grad_compression", "checkpoint",
                      "train_loop")} <= set(mods)
    # serving on a mesh
    assert {f"repro_torch.distributed.{m}"
            for m in ("sharding", "collectives", "elastic")} | {
        "repro_torch.launch.mesh"} <= set(mods)
    # the dry run
    assert {"repro_torch.launch.dryrun",
            "repro_torch.launch.op_analysis"} <= set(mods)
    code = ("import sys, importlib\n"
            "import repro_torch, repro_torch.serving.engine\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized(), 'an import started a group'\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
