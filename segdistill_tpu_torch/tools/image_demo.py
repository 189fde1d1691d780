"""Segment one image and paint the result over it (counterpart of
``tools/image_demo.py`` at the root of the repository; reference
``demo/image_demo.py``).

    python -m segdistill_tpu_torch.tools.image_demo <img> <config>
        [checkpoint] [--out-file demo_result.png] [--opacity 0.5]
        [--device cuda]

runs ``apis.inference_segmentor`` on the image (a file the port's
``utils/image.py`` reads: PNG, ``.npy``, or through OpenCV another format)
and writes the painted BGR image as PNG (``apis.show_result_pyplot``).
"""

import argparse

from ..apis import inference_segmentor, init_segmentor, show_result_pyplot


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='segment one image')
    parser.add_argument('img', help='image file')
    parser.add_argument('config', help='config file')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--out-file', default=None)
    parser.add_argument('--opacity', type=float, default=0.5)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None):
    """Segment and paint; -> the label map."""
    args = parse_args(argv)
    model = init_segmentor(args.config, args.checkpoint, device=args.device)
    result = inference_segmentor(model, args.img)
    out = args.out_file or 'demo_result.png'
    show_result_pyplot(model, args.img, result, opacity=args.opacity,
                       out_file=out)
    print(f'segmentation written to {out}')
    return result[0]


if __name__ == '__main__':
    main()
