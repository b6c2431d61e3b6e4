"""Host-side helpers of the port (copies of ``scan2cap_tpu/utils``)."""
