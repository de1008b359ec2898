"""``python -m landhydrology_tpu_torch`` — run a simulation from a JSON run file."""

from landhydrology_tpu_torch.cli import main

raise SystemExit(main())
