"""One-command FID/IS harness of the port (its counterpart of the JAX
package's ``tools/parity_harness.py``): a reference-format NET_G ``.pth``
(or a port run directory) and a data directory in, AttnGAN's sampling dump
(condGANTrainer.sampling, code/coco/attngan/trainer.py:387-472) and its FID
and IS out, as one JSON line with the metrics and their provenance.

    python -m multiple_objects_gan_tpu_torch.tools.parity_harness \\
        --net_g <netG .pth | port run dir> --data_dir <coco dir> \\
        [--img_dir <jpeg dir>] [--net_e <DAMSM text_encoder .pth>] \\
        [--cfg cfg/coco_attn_eval.yml] [--out <dir>] [--num_images 30000] \\
        [--seed N] [--device cuda|cpu]

The base cfg with TRAIN.FLAG False and the given NET_G, NET_E, DATA_DIR
and IMG_DIR is written to ``<out>/parity_eval.yml`` by the port's own
YAML writer (``config/config.py:dump_yaml``, which ``parse_yaml`` reads
back to the same values), then ``cli/main.py --eval_mode sampling`` runs on
the card (``--device cpu`` runs it on the CPU). The numbers are
comparable to published FID only with the pytorch-fid Inception weights
(``$FID_INCEPTION_WEIGHTS``), the torchvision IS head
(``$INCEPTION_V3_WEIGHTS``) and the DAMSM image encoder beside ``--net_e``:
``comparable_to_published`` says whether the run had all three.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys

from multiple_objects_gan_tpu_torch.cli import main as cli
from multiple_objects_gan_tpu_torch.config.config import (
    dump_yaml, parse_yaml)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_merged_cfg(base_cfg: str, out_dir: str, net_g: str, net_e: str,
                     data_dir: str, img_dir: str) -> str:
    """Write ``<out_dir>/parity_eval.yml``: the base cfg with TRAIN.FLAG
    False and TRAIN.NET_G set, and TRAIN.NET_E, DATA_DIR and IMG_DIR where
    given, all keys the reference schema has (the strict merge of
    ``cfg_from_file`` holds them to it). Returns its path."""
    with open(base_cfg) as f:
        doc = parse_yaml(f.read())
    train = doc.setdefault("TRAIN", {})
    train["FLAG"] = False
    train["NET_G"] = net_g
    if net_e:
        train["NET_E"] = net_e
    if data_dir:
        doc["DATA_DIR"] = data_dir
    if img_dir:
        doc["IMG_DIR"] = img_dir
    merged = os.path.join(out_dir, "parity_eval.yml")
    with open(merged, "w") as f:
        f.write(dump_yaml(doc))
    return merged


def comparable(metrics: dict) -> bool:
    """Whether the metric path had the published weights: the imported IS
    head and backbone, and the pytorch-fid canonical Inception for FID
    (the DAMSM backbone's FID is another metric)."""
    return (metrics.get("is_head") == "imported"
            and metrics.get("is_backbone") == "imported"
            and metrics.get("fid_encoder") == "fid_canonical")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--net_g", required=True,
                   help="reference netG .pth or a port run (or models/) dir")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--img_dir", default="")
    p.add_argument("--net_e", default="",
                   help="DAMSM text_encoder .pth; the image_encoder .pth "
                        "is looked up next to it (reference convention)")
    p.add_argument("--cfg", default=os.path.join(ROOT, "cfg",
                                                 "coco_attn_eval.yml"))
    p.add_argument("--out", default="")
    p.add_argument("--num_images", type=int, default=0,
                   help="cap the dump (0 = the whole test split; the "
                        "reference uses 30000)")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if not os.path.exists(args.net_g):
        sys.exit(f"--net_g not found: {args.net_g}")
    now = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    out_dir = args.out or os.path.join("output", f"parity_{now}")
    os.makedirs(out_dir, exist_ok=True)
    merged = build_merged_cfg(args.cfg, out_dir, args.net_g, args.net_e,
                              args.data_dir, args.img_dir)
    cli_argv = ["--variant", "coco-attngan", "--cfg", merged,
                "--output_dir", out_dir, "--manualSeed", str(args.seed),
                "--eval_mode", "sampling", "--device", args.device]
    if args.num_images:
        cli_argv += ["--num_images", str(args.num_images)]
    cli.main(cli_argv)

    metrics_path = os.path.join(out_dir, "eval_metrics.json")
    with open(metrics_path) as f:
        m = json.load(f)
    result = {**m, "net_g": args.net_g, "net_e": args.net_e or None,
              "samples_dir": os.path.join(out_dir, "single_samples"),
              "metrics_json": metrics_path,
              "comparable_to_published": comparable(m)}
    if not result["comparable_to_published"]:
        print("NOTE: non-canonical weights in the metric path "
              f"(is_head={m.get('is_head')}, "
              f"is_backbone={m.get('is_backbone')}, "
              f"fid_encoder={m.get('fid_encoder')}): the numbers are NOT "
              "comparable to published FID/IS; set $FID_INCEPTION_WEIGHTS "
              "to the pytorch-fid pt_inception .pth, pass --net_e, and set "
              "$INCEPTION_V3_WEIGHTS", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
