"""ctypes wrappers of the hand-written CUDA kernels in `csrc/`.

Each wrapper module holds one kernel: it checks its tensors, launches the
kernel for CUDA tensors through `build.launch` (on the tensor's device and
that device's current stream, raising on any CUDA error), counts its
launches in the module integer `launches`, and hands CPU tensors to the
kernel's plain PyTorch twin. The two TV modules (`tv_of_inner`,
`tv_de_inner`) also hold a single-pair entry that launches the same
kernel for one pair and counts in `launches_single`."""
