"""Small helpers of the port (counterpart of ``ray_tpu/util``)."""
