"""Port vs JAX package: sharded evaluation (`evaluate(mesh=...)`,
`make_predict_step(mesh=...)`) on two spawned gloo ranks
(tests/torch_dist_worker.py).

The trained flagship (bench_assets/ssdlite320_shapes_trained.npz, 91
classes, 320x320) over the train CLI's 9 synthetic validation frames:
each rank evaluates its shard of the loader (frames 0, 2, 4, 6, 8 and 1,
3, 5, 7 and, as padding, 0 again), 4 frames a batch, and the merged set
must hold every frame once and give the COCO summary of the JAX
package's single-process `evaluate` over all 9 frames with the same
weights, exactly (as the CLI test against the JAX CLI finds it,
tests/test_torch_entry_cli.py).
"""

import importlib
import os

import jax
import numpy as np
import pytest

from demonet_tpu.data.coco_eval import CocoEvaluator as JaxCoco
from demonet_tpu.data.loader import DetectionLoader as JaxLoader
from demonet_tpu.data.presets import DetectionPresetEval as JaxPresetEval
from demonet_tpu.data.synthetic import SyntheticDetection as JaxSynthetic
from demonet_tpu.models.builders import (
    ssdlite320_mobilenet_v3_large as jax_ssdlite,
)
from demonet_tpu.utils.checkpoints import load_npz_variables
from tests import torch_dist_worker as w
from tests.torch_parity import one_thread  # noqa: F401 (fixture)

jax_evaluate = importlib.import_module("demonet_tpu.engine.evaluate")

pytestmark = pytest.mark.usefixtures("one_thread")

_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_assets", "ssdlite320_shapes_trained.npz")
_FRAMES, _BATCH = 9, 4


@pytest.fixture(scope="module")
def jax_stats():
    jd = jax_ssdlite(num_classes=91)
    ds = JaxSynthetic(n=_FRAMES, num_classes=7, seed=1,
                      transforms=JaxPresetEval())
    ev = jax_evaluate.evaluate(
        jax_evaluate.make_predict_step(jd), load_npz_variables(_NPZ),
        JaxLoader(ds, _BATCH, image_size=(320, 320)),
        JaxCoco(ds.ground_truth_for_eval()))
    assert jax.process_count() == 1
    return ev.stats


def test_two_rank_evaluate_equals_jax_single_process(jax_stats, tmp_path):
    ranks = w.spawn(w.sharded_evaluate, 2, tmp_path, _NPZ, _FRAMES, _BATCH)
    assert ranks[0]["seen"] == [0, 2, 4, 6, 8]
    assert ranks[1]["seen"] == [1, 3, 5, 7, 0]     # the shard's padding
    assert np.isfinite(jax_stats).all() and jax_stats[1] > 0
    for r in ranks:
        assert r["merged"] == list(range(_FRAMES))
        np.testing.assert_array_equal(r["stats"], jax_stats)
