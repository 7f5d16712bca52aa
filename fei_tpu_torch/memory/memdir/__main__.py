from fei_tpu_torch.memory.memdir.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
