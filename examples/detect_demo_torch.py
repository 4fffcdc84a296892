"""Detection / segmentation postprocessing demo of paligemma_tpu_torch: the
counterpart of examples/detect_demo.py on the port's
``processing.detection`` and ``processing.mask_vae``, with its flags, output
and files, and no JAX.

It decodes a synthetic model output, the string a detection-tuned PaliGemma
emits for ``detect cat ; segment dog`` style prompts (with a real fine-tuned
checkpoint it comes from ``cli.infer --decode_detections``), so the demo
runs without weights:

    python examples/detect_demo_torch.py [--vae path/to/vae-oid.npz]

Outputs (./detect_demo_out/): boxes.json and one mask PNG per object (an
.npy where PIL is missing). Without ``--vae`` the mask decoder's weights are
random, drawn from a seeded ``torch.Generator``: masks of the right shape,
not meaningful ones.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from paligemma_tpu_torch.processing import detection as det  # noqa: E402
from paligemma_tpu_torch.processing import mask_vae  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--vae", default=None,
                   help="official vae-oid.npz for demo-parity masks "
                        "(random decoder weights otherwise)")
    p.add_argument("--out_dir", default="detect_demo_out")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    args = p.parse_args()

    # The model-output string: one plain box + one segmented object.
    text = (
        "<loc0102><loc0205><loc0716><loc0819> cat ; "
        "<loc0307><loc0410><loc0921><loc1000>"
        + "".join(f"<seg{i:03d}>" for i in range(0, 48, 3))
        + " dog"
    )
    print(f"model output:\n  {text}\n")

    objs = det.extract_objects(text)
    os.makedirs(args.out_dir, exist_ok=True)
    H, W = args.height, args.width

    boxes = [
        {"label": o.label, "box_yxyx": list(o.box_pixels(H, W)),
         "has_mask": o.seg_indices is not None}
        for o in objs
    ]
    with open(os.path.join(args.out_dir, "boxes.json"), "w") as f:
        json.dump(boxes, f, indent=2)
    print(json.dumps(boxes, indent=2))

    if args.vae:
        vae = mask_vae.load_vae_oid_npz(args.vae)
    else:
        print("\n(no --vae given: using random decoder weights — masks are "
              "shape-correct but not meaningful)")
        vae = mask_vae.init_params(torch.Generator().manual_seed(0))

    try:
        from PIL import Image
    except ImportError:
        Image = None

    for i, o in enumerate(objs):
        if o.seg_indices is None:
            m = det.render_box_masks([o], H, W)[0]
        else:
            logits = mask_vae.reconstruct_masks(vae, np.asarray([o.seg_indices], np.int32))
            soft = mask_vae.to_unit_range(logits[0])
            m = det.paste_mask_in_box(soft.astype(np.float32), o.box, H, W)
        path = os.path.join(args.out_dir, f"mask_{i}_{o.label}.png")
        if Image is not None:
            Image.fromarray((m * 255).astype(np.uint8)).save(path)
            print(f"wrote {path} ({int(m.sum())} px set)")
        else:
            np.save(path.replace(".png", ".npy"), m)


if __name__ == "__main__":
    main()
