"""Drivers: ``start()`` runs one Shapley round (``python -m
shapley_vit_tpu_torch.driver.start``); ``run_client()`` trains one FL client
and drops its checkpoints (``python -m shapley_vit_tpu_torch.driver.client``);
``run_demo()`` trains the clients and then scores them; ``serve()`` runs
rounds as checkpoint sets arrive (``python -m
shapley_vit_tpu_torch.driver.serve``), under the recycle supervisor
(``driver.supervisor``), with ``driver.status`` reading its output
directory."""
