"""nomad-tpu-torch: the PyTorch/CUDA port of nomad-tpu's scheduling wave.

The package mirrors ``nomad_tpu``'s layout so each module has an obvious
counterpart, and imports nothing of it (nor of JAX): what it needs from
pure-numpy modules there it keeps as its own copy.

Layer map (slices so far: the live placement wave, and the batched
schedule-apply loop):
  device.py    device resolution (``cuda`` unless the caller asks for cpu)
  tensors/     the numpy plane dataclasses (ClusterTensors, EvalTensors)
  ops/         KernelIn assembly, the torch composites (the joint wave,
               per-eval and eval-batched placement), the CUDA kernels
               (fused wave, lean batch placement, candidate scan) and
               their build
  parallel/    the wave coalescer, the batched schedule-apply loops and
               synthetic C2M-shaped and throughput problems
  convert.py   reads reference objects' planes by field name
"""

__version__ = "0.1.0"
