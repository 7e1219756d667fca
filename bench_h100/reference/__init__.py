"""Plain PyTorch references, one module per kind of configuration.
They import nothing of the program: the benchmark hands them the same
inputs and weights it hands the program, and they work out everything
else (routing, caches, panels) again for themselves."""

import contextlib

import torch


@contextlib.contextmanager
def fp32_highest():
    """float32 products as float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits), half to even, as the
    tensor cores read a float32 operand in TF32 mode."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    out = (bits + 0xFFF + lsb) & ~0x1FFF
    return out.view(torch.float32)


def mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product in TF32: operands rounded to TF32, products summed in
    float32 (the control: the nearest precision below float32)."""
    return torch.matmul(round_tf32(a), round_tf32(b))


#: the reference's precisions by name
PRECISIONS = {"fp32": mm_fp32, "tf32": mm_tf32}
