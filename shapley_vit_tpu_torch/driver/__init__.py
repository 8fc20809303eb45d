"""Drivers: ``start()`` runs one Shapley round (``python -m
shapley_vit_tpu_torch.driver.start``)."""
