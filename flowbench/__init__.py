"""flowbench: the benchmark of the PyTorch/CUDA port's node-agent engine
(antrea_tpu_torch.datapath.tpuflow.TpuflowDatapath.step).  See run.py."""
