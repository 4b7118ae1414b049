"""Evaluation entry points of the port: DNSMOS on the ONNX executor
(``dnsmos``) and the intrusive metrics (``intrusive``), with the flags and
output files of the repository's ``evaluation_metrics`` CLIs."""
