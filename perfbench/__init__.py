"""The benchmark of repro_torch, the PyTorch/CUDA port of GreenLLM.

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell once on the card and prints one JSON result line. See README.md.
"""
