"""The port stands alone: no jax, no deeplearning4j_tpu, no silent CPU.

Each check runs in a fresh interpreter, so nothing this test process has
imported (the JAX package, via conftest) can hide an import.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import deeplearning4j_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        deeplearning4j_tpu_torch.__path__, "deeplearning4j_tpu_torch."))


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)


# the modules of each slice; the walk below imports every module found
SLICE_MODULES = [
    "deeplearning4j_tpu_torch.serving.server",
    "deeplearning4j_tpu_torch.kernels.flash_attention",
    "deeplearning4j_tpu_torch.train.trainer",
    "deeplearning4j_tpu_torch.train.updaters",
    "deeplearning4j_tpu_torch.train.schedules",
    "deeplearning4j_tpu_torch.train.listeners",
    "deeplearning4j_tpu_torch.serde.checkpoint",
    "deeplearning4j_tpu_torch.data.dataset",
    "deeplearning4j_tpu_torch.ops.loss",
    "deeplearning4j_tpu_torch.ops.math",
    "deeplearning4j_tpu_torch.kernels.lstm_scan",
    "deeplearning4j_tpu_torch.ops.rnn",
    "deeplearning4j_tpu_torch.nn.model",
    "deeplearning4j_tpu_torch.nn.weightnoise",
    "deeplearning4j_tpu_torch.nn.layers.core",
    "deeplearning4j_tpu_torch.nn.layers.output",
    "deeplearning4j_tpu_torch.nn.layers.recurrent",
    "deeplearning4j_tpu_torch.models.zoo.classic",
    "deeplearning4j_tpu_torch.kernels.gru_scan",
    "deeplearning4j_tpu_torch.kernels.bitmap_pack",
    "deeplearning4j_tpu_torch.ops.compression",
    "deeplearning4j_tpu_torch.ops.cnn",
    "deeplearning4j_tpu_torch.ops.nn",
    "deeplearning4j_tpu_torch.nn.initializers",
    "deeplearning4j_tpu_torch.nn.layers.conv",
    "deeplearning4j_tpu_torch.nn.layers.norm",
    "deeplearning4j_tpu_torch.nn.config",
    "deeplearning4j_tpu_torch.models.lenet",
    "deeplearning4j_tpu_torch.models.zoo",
    "deeplearning4j_tpu_torch.models.zoo.resnet",
    "deeplearning4j_tpu_torch.data.iterators",
    "deeplearning4j_tpu_torch.data.mnist",
    "deeplearning4j_tpu_torch.evaluation",
    "deeplearning4j_tpu_torch.evaluation.classification",
    "deeplearning4j_tpu_torch.models.gpt",
    "deeplearning4j_tpu_torch.nn.generation",
    "deeplearning4j_tpu_torch.serving.generation",
    "deeplearning4j_tpu_torch.serving.overload",
    "deeplearning4j_tpu_torch.serving.errors",
    "deeplearning4j_tpu_torch.serving.client",
    "deeplearning4j_tpu_torch.serving.warmup",
    "deeplearning4j_tpu_torch.nn.layers",
    "deeplearning4j_tpu_torch.nn.layers.attention",
    "deeplearning4j_tpu_torch.nn.constraints",
    "deeplearning4j_tpu_torch.observability",
    "deeplearning4j_tpu_torch.observability.metrics",
    "deeplearning4j_tpu_torch.observability.flightrecorder",
    "deeplearning4j_tpu_torch.serving.cache",
    "deeplearning4j_tpu_torch.serving.metrics",
    "deeplearning4j_tpu_torch.serving.prefixkv",
    "deeplearning4j_tpu_torch.serving.warmstart",
    "deeplearning4j_tpu_torch.models.zoo.graphs",
    "deeplearning4j_tpu_torch.models.zoo.pixel",
    "deeplearning4j_tpu_torch.autodiff",
    "deeplearning4j_tpu_torch.autodiff.samediff",
    "deeplearning4j_tpu_torch.autodiff.validation",
    "deeplearning4j_tpu_torch.modelimport",
    "deeplearning4j_tpu_torch.modelimport.tf",
    "deeplearning4j_tpu_torch.modelimport.tf_proto",
    "deeplearning4j_tpu_torch.nn.activations",
    "deeplearning4j_tpu_torch.models.zoo.yolo",
    "deeplearning4j_tpu_torch.models.zoo.advanced",
    "deeplearning4j_tpu_torch.train",
    "deeplearning4j_tpu_torch.train.transfer",
    "deeplearning4j_tpu_torch.runtime.device",
    "deeplearning4j_tpu_torch.runtime.distributed",
    "deeplearning4j_tpu_torch.parallel.specs",
    "deeplearning4j_tpu_torch.parallel.data_parallel",
    "deeplearning4j_tpu_torch.modelimport.onnx",
    "deeplearning4j_tpu_torch.modelimport.onnx_proto",
]


def test_every_port_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert set(SLICE_MODULES) <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'deeplearning4j_tpu' "
        "or m.startswith('deeplearning4j_tpu.') or m == 'tensorflow' "
        "or m.startswith('tensorflow.') or m == 'google.protobuf' "
        "or m.startswith('google.protobuf.'))\n"
        "print(bad)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    code = (
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from deeplearning4j_tpu_torch.runtime.device import default_device\n"
        "from deeplearning4j_tpu_torch.models.bert import bert_tiny\n"
        "from deeplearning4j_tpu_torch.parallel.inference import "
        "ParallelInference\n"
        "from deeplearning4j_tpu_torch.serving import ModelRegistry, spec\n"
        "from deeplearning4j_tpu_torch.models.zoo.classic import "
        "text_generation_lstm\n"
        "from deeplearning4j_tpu_torch.models.zoo import lenet, resnet50\n"
        "from deeplearning4j_tpu_torch.models.gpt import gpt_tiny\n"
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch.autodiff import SameDiff, "
        "check_gradients\n"
        "calls = [default_device, lambda: bert_tiny(), lambda: gpt_tiny(),\n"
        "         lambda: SameDiff.create(),\n"
        "         lambda: check_gradients(lambda p: p['w'].sum(),\n"
        "                                 {'w': np.ones(2)}),\n"
        "         lambda: text_generation_lstm(),\n"
        "         lambda: lenet(), lambda: resnet50(),\n"
        "         lambda: ParallelInference(lambda v, x: x, {}),\n"
        "         lambda: ModelRegistry().register(\n"
        "             'm', lambda v, x: x, {}, input_spec=spec((2,)))]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA is not available' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('fell back to the CPU')\n"
        "print('refused', len(calls))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip() == "refused 10"


def test_explicit_cpu_is_honoured():
    code = (
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from deeplearning4j_tpu_torch.models.bert import bert_tiny\n"
        "m = bert_tiny(device='cpu', num_layers=1)\n"
        "print(m.device)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "cpu"


def test_distributed_entry_points_take_the_card_and_nccl_unless_asked():
    """``initialize()`` and ``build_mesh()`` (so ``Trainer(mesh=...)``)
    join NCCL on ``cuda:{LOCAL_RANK}`` by default and gloo only when asked
    for the CPU; without CUDA the default raises, as ``default_device``
    does, and no process group is made."""
    code = (
        "import os, tempfile, torch\n"
        "import torch.distributed as dist\n"
        "from deeplearning4j_tpu_torch.runtime import distributed as d\n"
        "from deeplearning4j_tpu_torch.runtime.device import build_mesh\n"
        "store = 'file://' + os.path.join(tempfile.mkdtemp(), 's')\n"
        "torch.cuda.is_available = lambda: False\n"
        "for call in (lambda: d.initialize(store, 1, 0),\n"
        "             lambda: build_mesh()):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA is not available' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('fell back to the CPU')\n"
        "    assert not dist.is_initialized()\n"
        "seen = []\n"
        "real = dist.init_process_group\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 2\n"
        "torch.cuda.set_device = lambda dev: seen.append(str(dev))\n"
        "dist.init_process_group = lambda backend, **kw: seen.append(backend)\n"
        "os.environ['LOCAL_RANK'] = '1'\n"
        "d.initialize(store, 2, 1)\n"
        "dist.init_process_group = real\n"
        "d.initialize(store, 1, 0, device='cpu')\n"
        "seen.append(dist.get_backend())\n"
        "mesh = build_mesh()\n"
        "seen.append(mesh.device_type)\n"
        "d.shutdown()\n"
        "print(seen)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip() == "['cuda:1', 'nccl', 'gloo', 'cpu']"
