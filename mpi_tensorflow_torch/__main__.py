from mpi_tensorflow_torch.cli import main

raise SystemExit(main())
