"""Parameters and forward FLOPs of a config's model (counterpart of
``tools/get_flops.py`` at the root of the repository).

    python -m segdistill_tpu_torch.tools.get_flops <config> [--shape H [W]]
        [--device cuda]

builds the model (the student of a distillation config) with random
weights and counts one ``encode_decode`` of a (1, 3, H, W) input under
``torch.utils.flop_counter.FlopCounterMode``. The count covers matrix
products and convolutions, 2 per multiply-add, and the SRA attention
operator (``fused_attention=True``) as the two products it replaces;
elementwise work, norms, softmax and resizes count 0 (the hand-written
resize-sum and LayerNorm operators too). The JAX tool reads XLA's cost
analysis of the compiled program instead, which counts every operation.
"""

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..apis import init_segmentor


def count(model, shape):
    """-> (parameters, FLOPs, {operator: FLOPs}) of ``model.encode_decode``
    on a zero input of ``shape`` (NCHW) on the model's device."""
    params = sum(p.numel() for p in model.parameters())
    device = next(model.parameters()).device
    img = torch.zeros(tuple(shape), device=device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model.encode_decode(img)
    by_op = {str(op): n for op, n in
             counter.get_flop_counts()['Global'].items()}
    return params, counter.get_total_flops(), by_op


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='model complexity')
    parser.add_argument('config')
    parser.add_argument('--shape', type=int, nargs='+', default=[512, 512])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None):
    """Print the report; -> (parameters, FLOPs, {operator: FLOPs})."""
    args = parse_args(argv)
    h, w = (args.shape * 2)[:2]
    model = init_segmentor(args.config, device=args.device)
    params, flops, by_op = count(model, (1, 3, h, w))
    sep = '=' * 60
    print(sep)
    print(f'Input shape: (1, 3, {h}, {w})')
    print(f'Params: {params / 1e6:.2f} M ({params})')
    print(f'FLOPs (matrix products and convolutions, 2 per multiply-add, '
          f'fwd): {flops / 1e9:.2f} G ({flops})')
    print(f'Multiply-adds: {flops / 2e9:.2f} G')
    for op, n in sorted(by_op.items(), key=lambda r: -r[1]):
        print(f'  {op}: {n / 1e9:.3f} G')
    print(sep)
    return params, flops, by_op


if __name__ == '__main__':
    main()
