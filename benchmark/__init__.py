"""The benchmark of ``ucod_dpl_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once and prints one JSON line.  Everything a cell needs
is found by name: ``workloads/<cell>.json`` (its configuration, driver and
traffic), ``configs/<config>.json`` (the model's sizes),
``drivers/<driver>.py`` (one kind of traffic), ``metrics/<metric>.py`` (one
per-layer metric and the spans it reads) and ``reference/`` (the plain
float32 PyTorch reference that decides ``correct``).
"""
