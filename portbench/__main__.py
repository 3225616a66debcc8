"""``python3 -m portbench``: the same as ``python3 portbench/run.py``."""

from portbench.run import main

raise SystemExit(main())
