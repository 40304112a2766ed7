"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or anything of the JAX package ``repro``; and
its entry points run on the card unless the caller asks for the CPU."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch import devices  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_finds_the_package():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/serving/engine.py",
            "src/repro_torch/kernels/moe/ops.py",
            "src/repro_torch/kernels/paged_attention.py",
            "src/repro_torch/kernels/flash_attention.py",
            "src/repro_torch/kernels/rwkv6_scan.py",
            "src/repro_torch/kernels/rmsnorm.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/core/reversible.py",
            "src/repro_torch/core/schedule.py",
            "src/repro_torch/models/model.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/train/trainer.py",
            "src/repro_torch/train/driver.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/launch/train.py",
            "chip_smoke.py"} <= names


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    model = Model(get_config("qwen2-moe-a2.7b", reduced=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        model.init_kv_pool(4, 8)
    with pytest.raises(RuntimeError):
        devices.resolve("cuda")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError):
        serve.main(["--requests", "1"])
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import driver
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--reduced", "--moe-backend", "grouped"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.train(model, AdamW(), DataConfig(), driver.RunConfig())
    assert devices.resolve("cpu").type == "cpu"
