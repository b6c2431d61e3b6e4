"""Evaluation (counterpart of ``scan2cap_tpu/eval``): caption metrics
gated by the detections (``eval_helper``), detection AP (``ap_helper``)
and the corpus scorers (``capeval``)."""
