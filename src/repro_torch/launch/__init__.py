"""Entry points (the counterpart of the reference package's ``launch``):
``train`` runs a training job on one device, ``train_anneal`` anneals its
step configuration on measured step times."""
