"""nomad-tpu-torch: the PyTorch/CUDA port of nomad-tpu's scheduling wave.

The package mirrors ``nomad_tpu``'s layout so each module has an obvious
counterpart, and imports nothing of it (nor of JAX): what it needs from
pure-numpy modules there it keeps as its own copy.

Layer map (this slice: the live placement wave, from the plane boundary
down to the hand-written Hopper kernel):
  device.py    device resolution (``cuda`` unless the caller asks for cpu)
  tensors/     the numpy plane dataclasses (ClusterTensors, EvalTensors)
  ops/         KernelIn assembly, the torch composite wave, the CUDA
               fused-wave kernel and its build
  parallel/    the wave coalescer and synthetic C2M-shaped problems
  convert.py   reads reference objects' planes by field name
"""

__version__ = "0.1.0"
