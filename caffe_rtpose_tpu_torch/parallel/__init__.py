"""Multi-device modes of the PyTorch port, on ``torch.distributed``.

* ``inference``: frame-parallel replicas, one a card (``DevicePool``);
* ``dp``: the mesh, the launcher and data-parallel training;
* ``multihost``: the multi-process training dry run;
* ``sp``: the trunk and the estimator H-sharded with halo exchanges;
* ``tp``: channel-sharded weights;
* ``mesh2d``: data x spatial training, data x model serving;
* ``pp``: GPipe over the CPM refinement stages;
* ``dryrun``: every mode at the flagship graphs' widths, on n ranks.
"""
