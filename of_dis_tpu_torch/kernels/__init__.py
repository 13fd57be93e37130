"""ctypes wrappers of the hand-written CUDA kernels in `csrc/`.

Each wrapper module holds one kernel: it checks its tensors, launches the
kernel for CUDA tensors through `build.launch` (on the tensor's device and
that device's current stream, raising on any CUDA error, the launch
counted per library and C entry in `trace`), and hands CPU tensors to the
kernel's plain PyTorch twin. The two TV modules (`tv_of_inner`,
`tv_de_inner`) also hold a single-pair entry that launches the same
kernel for one pair through a C entry of its own (`..._single`)."""
