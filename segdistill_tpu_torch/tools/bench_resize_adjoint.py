"""Time K1's backward (the adjoint of the resize-sum) three ways on the
card, in turns:

* ``atomic``: torch's ``upsample_bilinear2d_backward`` for each part, the
  backward of the eager step (it adds with atomics);
* ``matrix``: :func:`~..ops.resize_sum.resize_adjoint`, each part's
  adjoint as two products with the resize's dense (out, in) matrices, one
  along H and one along W: the backward of a CUDA graph's train step and
  of the eager steps of the same run (deterministic; its work grows as
  out x in a column);
* ``banded``: at a whole ratio s, each axis as one (3, s) x (s, X)
  product a block of s outputs (into its source and the two beside it)
  and two shifted adds (deterministic; a form tried and not taken).

    python -m segdistill_tpu_torch.tools.bench_resize_adjoint [--rounds 3]

For the SegFormer heads' shapes (the B0 head at batch 8 of 512x512, the
main path's; the B5 head, embed 768, at batch 2 of 640x640 and of
1024x1024) it prints one JSON line each: the median ms of a call by CUDA
events in each round (the arms in turns, the order reversed every other
round), the least time the card could take (the bf16 gradient read once,
the bf16 parts written once, at the memory rate), the largest difference
of each arm from ``atomic``, and whether two calls of each agree bitwise.
Needs a CUDA device; prints the card's name and power limit first.
"""

import argparse
import json
import subprocess

import torch

from ..ops.resize_sum import resize_adjoint, resize_matrix
from ..utils.timing import cuda_ms

PEAK_BYTES = 3.35e12
# (name, (B, H, W, C) of the head's grid, the parts' (h, w))
SHAPES = (
    ('B0 head, batch 8, 512x512', (8, 128, 128, 256),
     ((128, 128), (64, 64), (32, 32), (16, 16))),
    ('B5 head, batch 2, 640x640', (2, 160, 160, 768),
     ((160, 160), (80, 80), (40, 40), (20, 20))),
    ('B5 head, batch 2, 1024x1024', (2, 256, 256, 768),
     ((256, 256), (128, 128), (64, 64), (32, 32))),
)


def atomic(grad, parts):
    g = grad.permute(0, 3, 1, 2).float()
    H, W = grad.shape[1:3]
    out = []
    for (B, h, w, C), dtype in parts:
        d = torch.ops.aten.upsample_bilinear2d_backward(
            g, [H, W], [B, C, h, w], False, None, None)
        out.append(d.permute(0, 2, 3, 1).to(dtype))
    return out


# the block weights of ``banded``, for each (out, in)
BLOCKS = {}


def _blocks(out_size, in_size, device):
    """(in, 3, s): the s outputs of block j into source j, j - 1, j + 1."""
    if (out_size, in_size) not in BLOCKS:
        s = out_size // in_size
        m = resize_matrix(out_size, in_size).view(in_size, s, in_size)
        j = torch.arange(in_size)
        w = torch.zeros(in_size, 3, s)
        w[:, 0] = m[j, :, j]
        w[1:, 1] = m[j[1:], :, j[1:] - 1]
        w[:-1, 2] = m[j[:-1], :, j[:-1] + 1]
        BLOCKS[out_size, in_size] = w.to(device)
    return BLOCKS[out_size, in_size]


def _banded_axis(g, in_size):
    N, out_size, X = g.shape
    if out_size == in_size:
        return g
    w = _blocks(out_size, in_size, g.device)
    p = torch.matmul(w, g.view(N, in_size, w.shape[2], X))  # (N, in, 3, X)
    d = p[:, :, 0].contiguous()
    d[:, :-1] += p[:, 1:, 1]
    d[:, 1:] += p[:, :-1, 2]
    return d


def banded(grad, parts):
    B, H, W, C = grad.shape
    g = grad.float().contiguous()
    out = []
    for (_, h, w, _), dtype in parts:
        d = _banded_axis(g.view(B, H, W * C), h)
        d = _banded_axis(d.reshape(B * h, W, C), w)
        out.append(d.reshape(B, h, w, C).to(dtype))
    return out


ARMS = {'atomic': atomic, 'matrix': resize_adjoint, 'banded': banded}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--rounds', type=int, default=3)
    args = parser.parse_args(argv)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    for name, (B, H, W, C), sizes in SHAPES:
        grad = torch.randn(B, H, W, C, device='cuda', generator=gen,
                           dtype=torch.bfloat16)
        parts = [((B, h, w, C), torch.bfloat16) for h, w in sizes]
        want = [d.float() for d in atomic(grad, parts)]
        row = dict(shape=name, grad=[B, H, W, C], parts=sizes)
        for arm, fn in ARMS.items():
            a, b = fn(grad, parts), fn(grad, parts)
            row[f'{arm}_bitwise_twice'] = all(
                torch.equal(x, y) for x, y in zip(a, b))
            row[f'{arm}_max_abs_diff'] = max(
                (x.float() - y).abs().max().item() for x, y in zip(a, want))
        times = {arm: [] for arm in ARMS}
        for r in range(args.rounds):
            order = list(ARMS) if r % 2 == 0 else list(ARMS)[::-1]
            for arm in order:
                times[arm].append(cuda_ms(
                    lambda: ARMS[arm](grad, parts), iters=20, warmup=3))
        for arm, ms in times.items():
            row[f'{arm}_ms'] = ms
        moved = 2 * B * H * W * C + sum(2 * B * h * w * C for h, w in sizes)
        row['bound_ms'] = moved / PEAK_BYTES * 1e3
        print(json.dumps(row), flush=True)


if __name__ == '__main__':
    main()
