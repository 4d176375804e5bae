"""Plain PyTorch version of the blocked-matmul kernel, and the kernel's
summation order written out for the tests."""

import torch

#: the kernel's K-segment length, the unit of its summation order
#: (csrc/matmul.cu kSegLen)
SEG_LEN = 512


def matmul_ref(x: torch.Tensor, y: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ y`` computed in f32, returned in ``out_dtype`` (default:
    ``x``'s dtype).

    At 16 bits (bf16, f16) this is the plain version of the tensor-core
    kernel: the operands widened to f32, one f32 product, each entry
    rounded once to the output type. It shares with the kernel the f32
    accumulation of exact products (a product of two 16-bit values is
    exact in f32) and the one rounding at the end; it does not share the
    order of the sum: the kernel adds 16 terms inside each ``mma`` in the
    tensor core's own order, the k16 steps of a 512-term segment in
    ascending order, then the segments, where ``torch.matmul`` sums as its
    CPU or cuBLAS kernel does. So the two agree within one ulp of the output
    type plus the f32 reorder bound, not bit for bit."""
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.to(torch.float32), y.to(torch.float32)).to(out_dtype)


def matmul_in_kernel_order(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` summed in the kernel's order, in plain PyTorch (the tests
    use it; the wrapper never does): within each segment of 512 terms, from
    0, one fused multiply-add per term in ascending K; the segment sums
    added in ascending order into an f32 total. The fused multiply-add is
    taken in f64 and rounded once to f32, which is fmaf up to a rare double
    rounding."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    m, k = x.shape
    total = torch.zeros(m, y.shape[1], dtype=torch.float32)
    seg = torch.zeros_like(total)
    for j in range(k):
        seg = (x[:, j:j + 1].double() * y[j:j + 1].double() + seg.double()).float()
        if (j + 1) % SEG_LEN == 0 or j + 1 == k:
            total = total + seg
            seg = torch.zeros_like(seg)
    return total
