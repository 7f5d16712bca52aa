"""Fine-tune loop with checkpoint/resume on the PyTorch/CUDA port: the train
step (remat'd forward through the flash kernels, clip + AdamW) plus
safetensors composite checkpoints. The counterpart of
examples/train_finetune.py.

From the repository root:

    PYTHONPATH=. python examples/train_finetune_torch.py                # on the GPU, bf16
    PYTHONPATH=. python examples/train_finetune_torch.py --device cpu   # anywhere, fp32
"""

import argparse
import tempfile

import torch

from fei_tpu_torch.engine import restore_checkpoint, save_checkpoint
from fei_tpu_torch.engine.train import TrainConfig, make_optimizer, make_train_step
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.llama import init_params


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu")

    # on the card the flash kernels take bf16, T >= 64 and a head dim of 64, 80,
    # 128 or 256 (here 256 / 4 = 64); fp32 on the CPU takes the plain path
    dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
    cfg = get_model_config("tiny", num_layers=2, hidden_size=256, num_heads=4,
                           num_kv_heads=2, intermediate_size=512)
    tc = TrainConfig(learning_rate=3e-4, remat=True)
    params = init_params(cfg, seed=0, dtype=dtype, device=args.device)
    opt = make_optimizer(tc)
    opt_state = opt.init(params)
    _, train_step = make_train_step(cfg, tc, device=args.device)

    gen = torch.Generator().manual_seed(1)
    data = torch.randint(0, cfg.vocab_size, (4, 65), generator=gen)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        for step in range(args.steps):
            params, opt_state, loss = train_step(params, opt_state, data)
            print(f"step {step}: loss={float(loss):.4f}")
            if step == 2:
                save_checkpoint(ckpt_dir, step, params, opt_state=opt_state)
                print("  checkpointed at step 2")

        restored = restore_checkpoint(
            ckpt_dir, target={"params": params, "opt_state": opt_state},
            device=args.device)
        print(f"restored step-2 checkpoint (optimizer count "
              f"{int(restored['opt_state']['count'])}); resume with "
              "train_step(restored['params'], restored['opt_state'], ...)")


if __name__ == "__main__":
    main()
