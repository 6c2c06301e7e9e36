"""The export CLI (demonet_tpu_torch/export/cli.py, counterpart of
demonet_tpu/export/cli.py), driven through `main` with `--device cpu`.

Each weight flag (`--npz-weights`, `--checkpoint`, `--torch-weights`)
puts its weights into the program: the reloaded artifact is bit-equal to
the eager model loaded the same way. `--aoti` also writes the C++
runner's AOTInductor package, which the runner (built for the CPU) runs
bit-equal to the Python call. The JAX flags with another name here
(`--mlir` is `--aoti`, `--platforms` is `--device`) raise, naming theirs,
and without a GPU the CLI raises unless asked for the CPU. The Caffe
flags: tests/test_torch_caffe_cli.py.
"""

import os

import numpy as np
import pytest
import torch

from demonet_tpu_torch.engine.evaluate import make_predict_step
from demonet_tpu_torch.engine.state import TrainState, make_optimizer
from demonet_tpu_torch.export import cli, load_exported
from demonet_tpu_torch.models.builders import ssdlite320_mobilenet_v3_large
from demonet_tpu_torch.models.detection import preprocess
from demonet_tpu_torch.utils.checkpoints import (
    load_npz_variables,
    save_checkpoint,
)
from demonet_tpu_torch.utils.torch_weights import synthesize_torch_state_dict
from demonet_tpu_torch.utils.weights import (
    jax_variables_of,
    load_jax_variables,
)
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NPZ = os.path.join(_REPO, "bench_assets", "ssdlite320_shapes_trained.npz")
_MODEL = "ssdlite320_mobilenet_v3_large"


def _run(*argv):
    return cli.main(cli.get_args_parser().parse_args(list(argv)))


def _frames(b=1, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((b, 320, 320, 3)).astype(np.float32))


def test_cli_npz_weights_artifact_runs(tmp_path):
    """The command line of the README: the trained npz, 91 classes, on
    the CPU; the written artifact reloads and gives the eager step's
    detections, bit for bit."""
    out = str(tmp_path / "m.pt2")
    _run("--device", "cpu", "--num-classes", "91", "--npz-weights", _NPZ,
         "--output", out)
    det = ssdlite320_mobilenet_v3_large(num_classes=91, device="cpu")
    load_jax_variables(det.model, load_npz_variables(_NPZ))
    x = _frames()
    want = make_predict_step(det)(det.model, x)
    with torch.no_grad():
        got = load_exported(out).module()(x)
    assert want["valid"].any()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _weights_source(kind, tmp_path):
    """A seed-1 flagship's weights written as `kind`, the flag that reads
    them, and the model itself."""
    det = ssdlite320_mobilenet_v3_large(num_classes=91, device="cpu", seed=1)
    if kind == "checkpoint":
        state = TrainState(det.model, make_optimizer(0.1)(
            det.model.named_parameters()))
        return ["--checkpoint", save_checkpoint(str(tmp_path), state, 3)], det
    path = str(tmp_path / "w.pth")
    sd = synthesize_torch_state_dict(_MODEL, jax_variables_of(det.model))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return ["--torch-weights", path], det


@pytest.mark.parametrize("kind", ["checkpoint", "torch_weights"])
def test_cli_weight_flags_reach_the_artifact(kind, tmp_path):
    flag, det = _weights_source(kind, tmp_path)
    out = str(tmp_path / "raw.pt2")
    _run("--device", "cpu", "--raw-outputs", "--output", out, *flag)
    x = _frames(seed=2)
    with torch.no_grad():
        got = load_exported(out).module()(x)
        det.model.eval()
        want = det.model(preprocess(x, det.config, resize=False))
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_cli_bf16_and_batch_size(tmp_path):
    out = str(tmp_path / "bf16.pt2")
    _run("--device", "cpu", "--bf16", "--batch-size", "2", "--raw-outputs",
         "--output", out)
    with torch.no_grad():
        heads = load_exported(out).module()(_frames(2))
    assert heads["cls_logits"].dtype == torch.bfloat16
    assert heads["cls_logits"].shape[0] == 2


@pytest.mark.parametrize("argv,error,names", [
    # the id is the one this case had while --mlir was not ported
    pytest.param(["--mlir", "model.mlir"], ValueError, "--aoti",
                 id="argv3-NotImplementedError-11c"),
    pytest.param(["--platforms", "cpu"], ValueError, "--device",
                 id="argv4-ValueError---device"),
])
def test_cli_refuses_unported_flags(argv, error, names, tmp_path):
    with pytest.raises(error, match=names):
        _run("--device", "cpu", "--output", str(tmp_path / "x.pt2"), *argv)
    assert not os.path.exists(tmp_path / "x.pt2")


def test_cli_help_names_what_replaces_each_flag():
    text = cli.get_args_parser().format_help()
    for words in ("--aoti", "export/aoti.py", "--device", "torch.cond",
                  "caffemodel", "export/tracing.py", "export/caffe_eval.py"):
        assert words in text, words


def test_cli_aoti_writes_a_package_the_runner_runs(tmp_path):
    """--aoti with --raw-outputs: a package of the heads, which the C++
    runner runs bit-equal to its Python call."""
    from demonet_tpu_torch.export import aoti

    package = str(tmp_path / "heads_aoti.pt2")
    _run("--device", "cpu", "--num-classes", "5", "--raw-outputs",
         "--output", str(tmp_path / "heads.pt2"), "--aoti", package)
    shape = (1, 320, 320, 3)
    x = _frames(seed=3).numpy()
    x.tofile(str(tmp_path / "in.bin"))
    result = aoti.run_runner(aoti.build_runner("cpu"), package, shape,
                             iters=1, input_file=str(tmp_path / "in.bin"),
                             dump_out=str(tmp_path / "out"),
                             threads=torch.get_num_threads())
    assert result.outputs == [((1, 3234, 5), "Float"),
                              ((1, 3234, 4), "Float")]
    assert result.launches == {"nms_keep_batch": 0, "gather_rows_batch": 0,
                               "topk_sparse": 0}
    assert aoti.check_parity(package, str(tmp_path / "out"), x) == [0.0] * 2


def test_cli_without_gpu_needs_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run("--output", str(tmp_path / "x.pt2"))
