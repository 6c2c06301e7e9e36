#!/usr/bin/env python3
"""Predict img/s of one tree of the port on one NVIDIA GPU, measured as
chip_smoke.py's `e2e` phase measures it, for comparing two trees in one
call on one card:

    git archive <parent> | tar -x -C _checkout/parent
    for t in _checkout/parent . . _checkout/parent; do
        python3 e2e_ab.py $t | grep '^AB '
    done

Each run imports the tree's own `demonet_tpu_torch` and `chip_smoke`,
builds its kernels, loads the trained flagship (91 classes, 320x320, the
npz), and times `make_predict_step` closed loop, batch by batch, in the
reference, fused and sparse top-k modes: 30 batches at b32, 12 at b128,
after 3 warm-up calls, on seeded shapes frames. Prints one line, 'AB '
and a JSON object of img/s, median ms and quartiles per mode and batch.
Without a CUDA device it exits with 2.
"""
import json
import os
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    print("e2e_ab: no CUDA device; nothing run", file=sys.stderr)
    sys.exit(2)
from demonet_tpu_torch.ops import _build  # noqa: E402
_build.build_all()
import chip_smoke as cs  # noqa: E402
assert os.path.dirname(os.path.abspath(cs.__file__)) == tree, cs.__file__
from demonet_tpu_torch.engine.evaluate import make_predict_step  # noqa: E402
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
trained = cs.trained_detector("cuda")
out = {"tree": sys.argv[1]}
modes = {"reference": {}, "fused": {"impl": "fused"},
         "sparse_topk": {"topk_impl": "sparse_pallas"}}
for bs, iters in ((32, 30), (128, 12)):
    x = torch.from_numpy(
        cs.shapes_images(np.random.default_rng(bs), bs)[0]).cuda()
    sz = torch.tensor([[480, 640]] * bs, dtype=torch.int32, device="cuda")
    for mode, kw in modes.items():
        step = make_predict_step(trained, **kw)
        for _ in range(3):
            step(trained.model, x, sz)
        torch.cuda.synchronize()
        per = []
        for _ in range(iters):
            t0 = time.perf_counter()
            step(trained.model, x, sz)
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(per))
        out[f"{mode}_b{bs}"] = {
            "img_per_s": bs / med * 1e3, "ms_median": med,
            "q1_q3": [float(v) for v in np.percentile(per, [25, 75])]}
print("AB " + json.dumps(out), flush=True)
