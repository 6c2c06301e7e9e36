"""The plain reference that decides a run's `correct`.

Plain PyTorch and NumPy, float32 with TF32 off unless a control asks for
a lower precision. It imports nothing of the program under test, of the
JAX package or of JAX: every piece is a frozen copy of the published
arithmetic (SSD, arXiv:1512.02325; SSDLite and MobileNetV3,
arXiv:1905.02244; torchvision's detection models), kept beside the
benchmark so that later changes to the program cannot move it.

  * `nets`        -- the two detectors' forward passes (SSDLite320 +
                     MobileNetV3-Large, SSD300 + VGG16), with state_dict
                     names that the benchmark's weight maker fills;
                     another architecture's net is a file of its own,
                     `archs/<arch>.py`, built of `nets`' layers;
  * `boxes`       -- default boxes, the box coder, IoU;
  * `postprocess` -- softmax, decode, per-class top-k, greedy NMS, the
                     final top detections;
  * `loss`        -- the SSD matcher and the MultiBox loss with 3:1 hard
                     negative mining;
  * `sgd`         -- the warmup and step schedule and SGD with momentum
                     and coupled weight decay;
  * `npz`         -- the trained flagship's npz read into a state_dict.
"""
