"""The benchmark of the PyTorch/CUDA port (``awsegbench_torch``) on one
H100: ``python3 portbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``. See ``portbench/README.md``."""
