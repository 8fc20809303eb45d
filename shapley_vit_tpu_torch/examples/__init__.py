"""The port's examples (the JAX package's ``examples/``), inside the package:

    python -m shapley_vit_tpu_torch.examples.quickstart [--device cpu]
    python -m shapley_vit_tpu_torch.examples.serve_demo [--device cpu]
"""
