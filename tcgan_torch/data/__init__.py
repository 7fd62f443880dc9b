"""Dataset loading, fake-truth generation, minibatch sampling."""
