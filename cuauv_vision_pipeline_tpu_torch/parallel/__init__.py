"""Multi-camera fan-out and cross-camera merge on one card.

Port of ``cuauv_vision_pipeline_tpu.parallel``'s ``fanout`` and ``crosscam``.
The JAX package spreads cameras over a device mesh (``shard_map``, an
``all_gather`` for the merge); one card has no mesh, so each counterpart
here keeps the mesh form's contract and runs every camera as one batched
dispatch on one device. ``parallel/mesh.py`` (dp x tp meshes for training)
is not ported.
"""
