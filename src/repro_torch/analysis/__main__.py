from repro_torch.launch.analyze import main

if __name__ == "__main__":
    raise SystemExit(main())
