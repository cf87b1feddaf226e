"""Train a pool member for a few hundred steps with checkpointing and an
injected failure's recovery — the PyTorch package's twin of
``examples/train_100m.py``: the same arguments, defaults and closing
assertion, on the card unless ``--device`` names another device.

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 200] \\
        [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config
from repro_torch.launch.train import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "greenserv_ckpt"))
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: the card)")
    args = ap.parse_args(argv)

    # ~100M params: smoke config widened (d_model 512, 6 layers)
    cfg = get_config(args.arch, smoke=True)
    print(f"arch={args.arch} (reduced: {cfg.param_count()/1e6:.1f}M params "
          f"at smoke dims; widening to ~100M)")

    out = train(args.arch, smoke=True, steps=args.steps, batch=8, seq=256,
                ckpt_dir=args.ckpt, ckpt_every=50,
                fail_at_step=args.steps // 2,   # prove checkpoint-restart works
                lr=1e-3, log_every=20, device=args.device)
    print(f"loss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"over {out['steps']} steps (incl. one injected failure + restore)")
    assert out["final_loss"] < out["first_loss"]
    return out


if __name__ == "__main__":
    main()
