"""Multi-camera fan-out, cross-camera merge and the (data, model) mesh.

Port of ``cuauv_vision_pipeline_tpu.parallel``. ``mesh.py`` lays ranks out
as the JAX package lays out devices, on ``torch.distributed`` (one process
per rank, explicit collectives); ``fanout`` and ``crosscam`` each keep two
forms of the JAX mesh form's contract: on one card every camera rides one
batched dispatch, and on a mesh each rank runs its own camera (the merge
all-gathers the lists over the ranks).
"""
