"""On-card probes (counterparts of ``scripts/micro_mxu_pack_probe.py``,
``scripts/micro_mxu_shift_probe.py`` and ``scripts/micro_vmem_gather.py``),
``fps_variants`` (every variant of the FPS kernel timed at the five FPS
sites), ``timing`` (event and device-only timing shared by the probes and
``chip_smoke.py``) and ``cases`` (the edge cases the FPS and gather kernels
are held to).

Each probe runs with ``python -m scan2cap_torch.probes.<name>`` on the card
(``--device cpu`` runs the plain versions of pack, shift and gather)."""
