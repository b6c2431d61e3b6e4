"""On-card probes (counterparts of ``scripts/micro_mxu_pack_probe.py``,
``scripts/micro_mxu_shift_probe.py`` and ``scripts/micro_vmem_gather.py``).

Each runs with ``python -m scan2cap_torch.probes.<name>`` on the card
(``--device cpu`` runs the plain versions instead)."""
