"""The train state and the train step."""
