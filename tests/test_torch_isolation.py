"""The port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py`` and no kernel probe under ``tools/`` imports JAX or the
JAX package, and its entry points refuse to fall back to the CPU when no
device was asked for."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*_probe/*.py"))
BANNED = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "ops.py", "chip_smoke.py"} <= names
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_engine_without_device_raises():
    _no_cuda()
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import LPUEngine
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LPUEngine(model, model.init(0))


def test_serve_without_device_raises():
    _no_cuda()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


def test_kernel_build_is_lazy():
    """Importing the kernel modules builds nothing and needs no nvcc."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.gemv import ops as gemv_ops
    from repro_torch.kernels.mamba_scan import ops as mamba_ops
    from repro_torch.kernels.rwkv_scan import ops as rwkv_ops
    assert ops._fn is None or torch.cuda.is_available()
    assert ops._dense_fn is None or torch.cuda.is_available()
    assert gemv_ops._fn is None or torch.cuda.is_available()
    assert rwkv_ops._fn is None or torch.cuda.is_available()
    assert mamba_ops._fn is None or torch.cuda.is_available()
    assert mamba_ops._fused_fn is None or torch.cuda.is_available()
    assert set(build.SOURCES) == {"paged_decode_attention",
                                  "decode_attention", "gemv", "rwkv_scan",
                                  "mamba_scan"}
    for name in build.SOURCES:
        assert build.source_path(name).exists()
        assert build.library_path(name).parent == \
            ROOT / "build" / "repro_torch_kernels"
