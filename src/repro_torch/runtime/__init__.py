"""Runtime step builders (the counterpart of the reference package's
``runtime``), for one device: the serve steps, the train step with its
loss, and the fault supervisor."""
