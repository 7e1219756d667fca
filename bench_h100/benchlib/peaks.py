"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  Frozen here so that a change to
the program cannot move the yardstick."""

#: float32 on the CUDA cores (no tensor cores): the rate the port's
#: fp32 kernels run at
FP32_FLOPS = 67e12
#: TF32 on the tensor cores
TF32_FLOPS = 495e12
#: bf16 / fp16 on the tensor cores
BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes a second
HBM_BYTES = 3.35e12
#: device memory, bytes
HBM_CAPACITY = 80e9
