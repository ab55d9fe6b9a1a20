"""Serving on the continuous engine (continuous.py), the Redis worker
(worker.py), its jobs (jobs.py) and the object store (storage.py): the
PyTorch port's counterparts of `chatterbox_embed_tpu/serving/`."""
