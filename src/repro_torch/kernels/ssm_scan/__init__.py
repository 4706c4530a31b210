"""K6: the Mamba-1 selective scan (``csrc/ssm_scan.cu``)."""
