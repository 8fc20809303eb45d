"""shapley_vit_tpu_torch — the PyTorch/CUDA port of ``shapley_vit_tpu``.

Same system, same layout, same function names: federated-learning clients
fine-tune a LoRA-adapted ViT; the Shapley server ingests their LoRA deltas,
FedAvg-combines them per coalition, evaluates every coalition's ViT on the
validation set in one batched pass, and scores the clients with the Shapley
estimators. The JAX package is the reference each module is tested against;
this package imports nothing of it (and never ``jax``) and keeps its own
copies of the host-side modules it needs.

Parameters are nested dicts of tensors with the JAX tree's key names, so
weights move between the two packages as numpy (``models.convert``). The
three kernels the JAX package wrote in Pallas for the TPU and that the
Shapley round runs (patch embedding, packed attention, fused MLP block) are
hand-written CUDA C++ for Hopper under ``csrc/``, and so is a fourth of the
port's own, the LayerNorm the JAX package leaves to XLA's fusion; each op
wrapper launches its kernel for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor.

Layer map:
  config     — typed config tree (copy of shapley_vit_tpu.config)
  data       — array datasets, OCT loader, registry (OCT entry)
  models     — functional ViT + LoRA overlay, weight conversion/carrier
  ops        — dict-of-tensor tree algebra, the Hopper kernels' wrappers, int8
  fl         — evaluation, checkpoint ingestion (native inotify watcher),
               client/server records, utility table and round fingerprints
  shapley    — Game + comp-contrib/exact estimators (numpy copies)
  driver     — start() (one round), serve() (the service), supervisor, status,
               client training, demo, round reports
  utils      — logging (CSV, TensorBoard), profiling, meters
"""

__version__ = "0.1.0"
