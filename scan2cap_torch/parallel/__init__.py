"""The mesh layer of the port (counterpart of ``scan2cap_tpu/parallel``):
``--mesh DATA,MODEL`` as DATA x MODEL processes over ``torch.distributed``
(``mesh``), and the point-axis sharding of the set-abstraction layers
(``spatial``, ``--spatial``)."""
