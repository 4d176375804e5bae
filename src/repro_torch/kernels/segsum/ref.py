"""Plain PyTorch version of the segment-sum kernel, and the kernel's
summation order written out for the tests."""

import torch

#: terms per chunk of the kernel's summation order (csrc/segsum.cu kChunk)
CHUNK = 256


def segment_sum_ref(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_e [seg_e = s]·msg[e]`` over ``num_segments`` rows, in
    ``msg``'s dtype, summed in f32 at least (f64 stays f64) and rounded
    once. Ids outside ``[0, num_segments)`` (the COO padding id -1 among
    them) are dropped."""
    acc = torch.promote_types(msg.dtype, torch.float32)
    out = torch.zeros((num_segments,) + tuple(msg.shape[1:]), dtype=acc, device=msg.device)
    if num_segments == 0 or msg.shape[0] == 0:
        return out.to(msg.dtype)
    valid = (seg >= 0) & (seg < num_segments)
    vals = torch.where(
        valid.reshape((-1,) + (1,) * (msg.dim() - 1)), msg.to(acc), torch.zeros((), dtype=acc, device=msg.device)
    )
    return out.index_add_(0, seg.clamp(0, num_segments - 1), vals).to(msg.dtype)


def segment_sum_in_kernel_order(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The segment sum of ``msg`` (E, D) in the kernel's order, in plain
    PyTorch (the tests use it; the wrapper never does): segment s's valid
    terms in ascending edge index, cut into chunks of ``CHUNK``; each chunk
    summed from 0 in f32, one add per term; the chunk sums added in
    ascending order into a total that starts at 0; the total rounded once
    to ``msg``'s dtype. Every add below adds one term to distinct rows, so
    it is one IEEE f32 add per entry, as in the kernel."""
    dev, d = msg.device, msg.shape[1]
    total = torch.zeros((num_segments, d), dtype=torch.float32, device=dev)
    valid = (seg >= 0) & (seg < num_segments)
    edges = torch.nonzero(valid).squeeze(1)                  # ascending e
    if edges.numel() == 0:
        return total.to(msg.dtype)
    ids, order = torch.sort(seg[edges].long(), stable=True)
    edges = edges[order]
    counts = torch.bincount(ids, minlength=num_segments)
    first = torch.cumsum(counts, 0) - counts                 # a segment's first term
    place = torch.arange(ids.numel(), device=dev) - first[ids]   # its place among them
    chunks = (counts + CHUNK - 1) // CHUNK
    chunk_first = torch.cumsum(chunks, 0) - chunks
    row = chunk_first[ids] + place // CHUNK                   # the term's chunk
    vals = msg[edges].to(torch.float32)
    sums = torch.zeros((int(chunks.sum()), d), dtype=torch.float32, device=dev)
    for p in range(min(CHUNK, int(counts.max()))):
        at = place % CHUNK == p
        r = row[at]
        sums[r] = sums[r] + vals[at]
    owner = torch.repeat_interleave(torch.arange(num_segments, device=dev), chunks)
    index = torch.arange(owner.numel(), device=dev) - chunk_first[owner]
    for c in range(int(chunks.max())):
        at = index == c
        s = owner[at]
        total[s] = total[s] + sums[at]
    return total.to(msg.dtype)
