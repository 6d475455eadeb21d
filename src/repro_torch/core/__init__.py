"""Core prefix-scan system of the port (mirrors ``repro/core``).

  circuits.py        prefix-circuit IR + generators (paper Table 1)
  engine/            circuit → plan compiler, backend registry, cost-model
                     dispatch — the one public ``scan()`` entry point
  scan.py            vector/element execution + blocked local-global-local
  work_stealing.py   threaded Algorithm-1 stealing (paper §4.3)
  registration.py    the image-registration operator the paper scans
"""
