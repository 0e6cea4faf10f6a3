"""Export a trained checkpoint to a serving artifact (the twin of
``scripts/export_serving.py``).

Bridges the reference deployment unit (json structure + h5 weights) to the
port's: ``InferenceRunner.export_program``, a ``torch.export`` program with
the weights in it, which ``load_serving_artifact`` reloads with torch and
the port's depthwise op alone (no model code).

    python -m dorknet_tpu_torch.tools.export_serving \\
        --json net.json --h5 epoch_26_testacc_0.686.h5 \\
        --out dogs_serving.pt2 \\
        --input 3,225,225 --batch 128 [--no-fold-bn] [--bf16] \\
        [--polymorphic] [--device cuda]

The artifact runs on the device it was exported on (``--device``, the card
by default). Reading the h5 file needs ``h5py``, which the machine with the
card lacks, so this tool is tested on the CPU only; an artifact for the card
is exported on a machine that has both. The JAX script's ``--int8``, ``--scales`` and
``--dw-weight-only`` wait for the port's int8 runner; ``--platforms`` has no
counterpart (no cross-device export).

Verify at the destination with:

    from dorknet_tpu_torch.serving_artifact import load_serving_artifact
    art = load_serving_artifact("dogs_serving.pt2")
    probs = art.predict_probs(images_nchw)
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", required=True, help="layer-structure json")
    ap.add_argument("--h5", required=True, help="weights h5")
    ap.add_argument("--out", required=True, help="artifact output path")
    ap.add_argument("--input", default="3,225,225",
                    help="per-image C,H,W (default: the dogs flagship)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--no-fold-bn", action="store_true",
                    help="serve unfolded BN (default folds conv→BN pairs)")
    ap.add_argument("--bf16", action="store_true",
                    help="export under the bf16 activation-flow policy")
    ap.add_argument("--polymorphic", action="store_true",
                    help="symbolic batch dim: one artifact, any batch size")
    ap.add_argument("--device", default="cuda",
                    help="the device the artifact runs on (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from dorknet_tpu_torch import config
    from dorknet_tpu_torch.network import FeedForwardNetwork, InferenceRunner

    net = FeedForwardNetwork("export")
    net.load_network_from_json_and_h5(args.json, args.h5)
    runner = InferenceRunner(net, batch_size=args.batch, device=args.device,
                             fold_bn=not args.no_fold_bn)
    C, H, W = (int(d) for d in args.input.split(","))
    before = config.get_compute_dtype()
    if args.bf16:
        config.set_compute_dtype(torch.bfloat16)
    try:
        data = runner.export_program((H, W), channels=C, path=args.out,
                                     polymorphic_batch=args.polymorphic)
    finally:
        config.set_compute_dtype(before)
    print("wrote {} ({:.1f} MiB) + {}.meta.json".format(
        args.out, len(data) / 2**20, args.out))


if __name__ == "__main__":
    main()
