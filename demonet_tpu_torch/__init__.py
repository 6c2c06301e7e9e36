"""demonet_tpu_torch — the PyTorch/CUDA port of the JAX package `demonet_tpu`.

The package mirrors `demonet_tpu`'s module names so each piece has an
obvious counterpart, and keeps its public layouts: images are NHWC
(B, H, W, 3), detections come back as padded (B, D, ...) tensors with a
`valid` mask. Convolutions run NCHW inside the modules.

The hand-written CUDA kernels (`csrc/*.cu`) are compiled with nvcc and
loaded at their first call on a CUDA tensor, never on import, so the
package imports on a host with no GPU, no nvcc and no triton.

    from demonet_tpu_torch.models.builders import ssdlite320_mobilenet_v3_large
    det = ssdlite320_mobilenet_v3_large(num_classes=91)      # on cuda
    dets = det.predict(images_uint8_nhwc)

Training: `engine.state.create_train_state(det, make_optimizer(...))`,
`engine.train.make_train_step(det)` and `train_one_epoch`. The CLIs:
`python -m demonet_tpu_torch.train`, `.predict` and `.eval_voc`; models
with their weights: `hub.load(name, weights=...)`.
"""

__version__ = "0.1.0"
