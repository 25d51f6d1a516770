"""CLI: convert a reference torch snapshot (.pt) into a port snapshot (.pt)
that the runners' ``--load`` reads. The port of
eoe_tpu/main/import_snapshot.py, which writes a msgpack snapshot instead.

Run: python -m eoe_tpu_torch.main.import_snapshot snapshot_cls0_it0.pt out.pt
Supported architectures (sniffed from the state dict): CNN28/CNN32,
WideResNet+CBAM, torchvision (wide_)resnet50 trunks, OpenAI-style CLIP. A
host tool: it reads and writes files on the CPU and touches no card.
"""

import argparse

from eoe_tpu_torch.models.torch_import import import_torch_snapshot


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", help="reference torch snapshot (.pt)")
    p.add_argument("output", help="output port snapshot (.pt)")
    args = p.parse_args(argv)
    out = import_torch_snapshot(args.input, args.output)
    print(f"Wrote {out}")
    return out


if __name__ == "__main__":
    main()
