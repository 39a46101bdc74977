"""The contract checks' two fixture kernels (``copy_kernel``, ``iota_kernel``)."""
