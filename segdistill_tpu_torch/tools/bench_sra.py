"""Check and time the SRA attention kernels (K2 forward, K9 backward) on
the card, beside their bounds: the quick loop for work on these kernels
(``chip_smoke.py`` holds them to their stated limits and times a library
call beside them).

    python -m segdistill_tpu_torch.tools.bench_sra [--quick]

Builds only ``csrc/sra_attn.cu`` and ``csrc/sra_attn_bwd.cu`` (two ``nvcc``
at once) and prints ptxas' registers and spills. Then, for the four
Segformer-B0 stages at 512x512 (batch 1 and 8), the B1-B5 stage-1 shape
(d = 64) and a few ragged shapes, in fp32 and bf16: the largest error of
the kernels against the plain version in fp32, whether two backward runs
agree bitwise, and the median device time (the calls queued behind a busy
stream, so the host's time to launch them is left out) of K2, of K2 keeping
the log-sum-exp and of K9, beside the least time the card could take
(``--quick``: the checks and one short timing round only). Needs a CUDA
device; prints the card's name and power limit first.
"""

import argparse
import subprocess

import numpy as np
import torch

from ..ops import sra_attn
from ..ops.cuda_kernel import build_all
from ..utils.timing import device_ms

PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
B0_STAGES = ((1, 16384), (2, 4096), (5, 1024), (8, 256))  # (heads, N)


def bounds_ms(b, h, n, m, d, dtype):
    """(forward, backward) least times: bytes (inputs read once, outputs
    written once) over the memory rate against the products at the
    inputs' peak plus the softmax terms (5 NM forward, 8 NM backward) at
    the fp32 rate."""
    size = 2 if dtype == torch.bfloat16 else 4
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    bh = b * h
    fwd_bytes = bh * size * (2 * n * d + 2 * m * d)
    bwd_bytes = bh * (size * (2 * n * d + 2 * m * d) + 4 * n * d + 4 * n
                      + size * (n * d + 2 * m * d))
    fwd = max(fwd_bytes / PEAK_BYTES,
              bh * (4 * n * m * d / peak + 5 * n * m / PEAK_F32))
    bwd = max(bwd_bytes / PEAK_BYTES,
              bh * (10 * n * m * d / peak + 8 * n * m / PEAK_F32))
    return fwd * 1e3, bwd * 1e3


def _head_split(b, rows, heads, d, n_maps, rng, dtype):
    mem = torch.from_numpy(rng.randn(b, rows, n_maps * heads * d)
                           .astype(np.float32)).to('cuda', dtype)
    return mem.view(b, rows, n_maps, heads, d).permute(2, 0, 3, 1, 4)


def _err(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def run_case(name, b, h, n, m, d, dtype, rng, iters):
    scale = d ** -0.5
    q = _head_split(b, n, h, d, 1, rng, dtype)[0].requires_grad_()
    k, v = (t.requires_grad_()
            for t in _head_split(b, m, h, d, 2, rng, dtype))
    g = _head_split(b, n, h, d, 1, rng, dtype)[0]
    out = sra_attn.sra_attention_train(q, k, v, scale)
    got = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    with torch.no_grad():
        fwd_only = sra_attn.fused_sra_attention(q, k, v, scale)
    torch.cuda.synchronize()
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want_out = sra_attn.sra_attention_plain(*ref, scale)
    want = torch.autograd.grad(want_out, ref, g.float())
    errs = [_err(out, want_out.detach()), _err(fwd_only, want_out.detach())]
    errs += [_err(a, w) for a, w in zip(got, want)]
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    with torch.no_grad():
        k2 = device_ms(lambda: sra_attn.fused_sra_attention(q, k, v, scale),
                       iters=iters)
    k2_lse = device_ms(lambda: sra_attn.sra_attention_train(q, k, v, scale),
                       iters=iters)
    k9 = device_ms(lambda: torch.autograd.grad(
        out, (q, k, v), g, retain_graph=True), iters=iters)
    bf, bb = bounds_ms(b, h, n, m, d, dtype)
    plan = sra_attn.backward_plan(dtype, b * h, n, m, d)
    print(f'{name:18s} {str(dtype)[6:]:8s} err/max out {errs[0]:.2e} fwd '
          f'{errs[1]:.2e} dq {errs[2]:.2e} dk {errs[3]:.2e} dv {errs[4]:.2e} '
          f'bitwise {same} | K2 {k2:.4f} (lse {k2_lse:.4f}) '
          f'bound {bf:.4f} | K9 {k9:.4f} bound '
          f'{bb:.4f} ms | splits {plan["splits"]} x {plan["rows"]} rows, '
          f'{plan["key_chunks"]} key chunks', flush=True)
    if not same:
        raise AssertionError(f'{name}: K9 is not deterministic')
    # a coarse gate for work in progress (errors over the largest value);
    # the stated limits are chip_smoke.py's
    limit = 2e-5 if dtype == torch.float32 else 2.0 ** -5
    if not max(errs) <= limit:
        raise AssertionError(f'{name} {dtype}: errors {errs}')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--quick', action='store_true')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('bench_sra: needs a CUDA device')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = [sra_attn.KERNEL, sra_attn.BWD_KERNEL]
    build_all(kernels)
    for kern in kernels:
        print(f'{kern.name}: built in {kern.build_seconds:.1f} s')
        for line in kern.build_log.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print('  ' + line.strip())
    cases = [(f'B0 stage{s + 1} b{b}', b, h, n, 256, 32)
             for b in (1, 8) for s, (h, n) in enumerate(B0_STAGES)]
    cases += [('stage1 d64 b2', 2, 1, 16384, 256, 64),
              ('B3 stage2 d64 b8', 8, 2, 4096, 256, 64),
              ('ragged N, M', 2, 2, 1000, 100, 32),
              ('M 300 (640x480)', 1, 1, 19200, 300, 32),
              ('M 2048', 1, 1, 4096, 2048, 32),
              ('d128', 1, 2, 300, 70, 128), ('d16 M3', 1, 2, 40, 3, 16)]
    rng = np.random.RandomState(0)
    for _ in range(1 if args.quick else 2):
        for name, b, h, n, m, d in cases:
            for dtype in (torch.float32, torch.bfloat16):
                run_case(name, b, h, n, m, d, dtype, rng,
                         iters=2 if args.quick else 5)
    print('bench_sra: ok')


if __name__ == '__main__':
    main()
