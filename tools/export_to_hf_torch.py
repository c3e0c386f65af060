"""Convert between dolomite and HF checkpoint directories with the PyTorch port.

    python tools/export_to_hf_torch.py LOAD_DIR SAVE_DIR [--model-type llama]
    python tools/export_to_hf_torch.py HF_DIR DOLOMITE_DIR --import

The port's counterpart of `tools/export_to_hf.py` (which exports ``load/`` to ``save/`` as
llama): export writes an HF ``--model-type`` directory (llama, granite, granitemoe,
mixtral, gpt_bigcode, t5) from a dolomite one; ``--import`` converts an HF directory the
other way (its type read from its ``config.json``). No JAX is needed.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from dolomite_engine_tpu_torch.hf_interop import export_to_huggingface, import_from_huggingface  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("load_path")
    p.add_argument("save_path")
    p.add_argument("--model-type", default="llama", help="the HF model type to export to")
    p.add_argument("--import", dest="import_", action="store_true", help="convert an HF directory into a dolomite one")
    args = p.parse_args(argv)
    if args.import_:
        import_from_huggingface(args.load_path, args.save_path)
    else:
        export_to_huggingface(args.load_path, args.save_path, model_type=args.model_type)
    print(f"wrote {args.save_path}")


if __name__ == "__main__":
    main()
