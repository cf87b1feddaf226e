"""Router core: context features, contextual bandits, the router."""
