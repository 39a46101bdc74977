"""The prefix-sum resamplers (paper §6.5: multinomial Alg. 7, systematic and
improved systematic Alg. 8, stratified, residual) for Hopper."""
